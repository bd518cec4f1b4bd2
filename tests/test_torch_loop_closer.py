"""PyTorch port: LoopCloser's batched resolution (run/full_slam.py)
against the JAX package's, on tests/test_loop_closer.py's five cases. The
same stubbed entries (the verdicts of already-run attempts) go to both
closers, whose attempt kernels and accept tails are stubbed; the accepts,
the reissues, the attempt records and the returned cooldown, admission
reference and correction must be equal (the records to float32 rounding:
1e-6)."""

import numpy as np
import torch

import slam2d_tpu.config as jcfg
from slam2d_tpu.run import full_slam as jfs
from slam2d_tpu_torch.run import full_slam as tfs
from test_loop_closer import GCFG, entry
from torch_parity import to_port

torch.set_num_threads(1)


def _closers(n_kf=20):
    """(JAX closer, port closer), each with its accepts and reissues
    recorded, as tests/test_loop_closer.py:make_closer builds them."""
    cfg = jcfg.FrontendConfig(
        sensor=jcfg.SensorConfig(n_beams=8, max_range=5.0),
        grid=jcfg.GridConfig(height=64, width=64, resolution=0.1),
        matcher=jcfg.MatcherConfig(),
    )
    out = []
    for mod, c, g in ((jfs, cfg, GCFG), (tfs, to_port(cfg), to_port(GCFG))):
        kf_poses = [np.array([0.1 * k, 0.0, 0.0], np.float32)
                    for k in range(n_kf)]
        extra = {} if mod is jfs else {"device": torch.device("cpu")}
        closer = mod.LoopCloser(
            c, g, mod.default_loop_matcher(g), mod.default_submap_grid(c),
            3, None, kf_poses, [None] * n_kf, list(range(n_kf)),
            np.zeros((n_kf, 8), np.float32), np.zeros((100, 3), np.float32),
            "dense", 200.0, 0, lambda est: None, [], defer_accept=False,
            **extra,
        )
        log = {"accepts": [], "reissues": []}

        def accept(i, k, z, sc, est, upto, closer=closer, log=log):
            log["accepts"].append((i, k))
            return est, closer.kf_poses[-1].copy(), np.zeros(3, np.float32)

        closer._accept = accept
        closer.issue = lambda k_new, scan_i, log=log: (
            log["reissues"].append(k_new))
        out.append((closer, log))
    return out


def _resolve_both(pending, n_kf=20, est=None):
    est = np.zeros(3, np.float32) if est is None else est
    results = []
    for closer, log in _closers(n_kf):
        closer.pending = [dict(e) for e in pending]
        cd, est_out, nl, T = closer.resolve(est.copy(), 50)
        results.append((closer, log, cd, est_out, nl, T))
    (cj, lj, *rj), (ct, lt, *rt) = results
    assert lt == lj
    assert rt[0] == rj[0]                                  # cooldown
    np.testing.assert_array_equal(rt[1], rj[1])            # est
    for a, b in zip(rt[2:], rj[2:]):                       # last kf, T
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)
    rec_j = np.asarray(cj.attempt_records, np.float32).reshape(-1, 10)
    rec_t = np.asarray(ct.attempt_records, np.float32).reshape(-1, 10)
    assert rec_t.shape == rec_j.shape
    np.testing.assert_allclose(rec_t, rec_j, rtol=0, atol=1e-6)
    assert ct.pending == [] and cj.pending == []
    return lt, rt, rec_t


def test_gates_reject_and_record():
    log, (cd, _, nl, _), rec = _resolve_both([
        entry(5, score=0.2),
        entry(6, score=0.9, margin=0.01),
        entry(7, score=0.9, corr=(2.0, 0, 0)),
        entry(8, score=0.9, corr=(0, 0, 0.9)),
    ])
    assert log["accepts"] == [] and cd is None and nl is None
    assert rec.shape == (4, 10) and (rec[:, 6] == 0.0).all()


def test_first_accept_wins_drop_and_reissue():
    log, (cd, _, nl, _), rec = _resolve_both([
        entry(10, score=0.3),
        entry(12, score=0.9),
        entry(14, score=0.9),
        entry(16, score=0.9),
    ])
    assert log["accepts"] == [(0, 12)] and log["reissues"] == [16]
    assert list(rec[:, 1]) == [10.0, 12.0] and rec[1, 6] == 1.0
    assert nl is not None and cd == 0


def test_cooldown_backdating_partial():
    log, (cd, _, _, _), _ = _resolve_both([entry(12, score=0.9)], n_kf=14)
    assert log["accepts"] == [(0, 12)]
    assert cd == GCFG.loop_cooldown - 1


def test_empty_pending_noop():
    log, (cd, est, nl, T), rec = _resolve_both([], est=np.ones(3, np.float32))
    assert cd is None and nl is None and T is None and len(rec) == 0
    np.testing.assert_array_equal(est, np.ones(3, np.float32))


def test_deferred_accept_queues_issues():
    """defer_accept=True: an accept only dispatches at its resolve; an
    issue() while it is in flight queues, and goes out after the next
    resolve has finalized the accept: the same in both packages."""
    traces = []
    for closer, _ in _closers():
        closer.defer_accept = True
        trace = {"dispatched": [], "finalized": 0, "issued": []}

        def dispatch(i, k, z, sc, closer=closer, trace=trace):
            trace["dispatched"].append((i, k))
            closer.pending_accept = {"n0": len(closer.kf_poses)}

        def finalize(est, upto, closer=closer, trace=trace):
            trace["finalized"] += 1
            closer.pending_accept = None
            return est, closer.kf_poses[-1].copy(), np.zeros(3, np.float32)

        closer._accept_dispatch = dispatch
        closer._finalize_accept = finalize
        closer.pending = [entry(12, score=0.9)]
        r1 = closer.resolve(np.zeros(3, np.float32), 50)
        type(closer).issue(closer, 19, 19)
        trace["queued"] = list(closer.deferred_issues)
        closer.issue = lambda k, s, trace=trace: trace["issued"].append((k, s))
        r2 = closer.resolve(np.zeros(3, np.float32), 60)
        trace["r"] = [(r[0], r[2] is None, r[3] is None) for r in (r1, r2)]
        trace["in_flight"] = closer.pending_accept
        traces.append(trace)
    assert traces[1] == traces[0]
    t = traces[1]
    assert t["dispatched"] == [(0, 12)] and t["finalized"] == 1
    assert t["queued"] == [(19, 19)] and t["issued"] == [(19, 19)]
    assert t["r"][0][1:] == (True, True) and t["r"][0][0] is not None
    assert t["r"][1] == (None, False, False) and t["in_flight"] is None
