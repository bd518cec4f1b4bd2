"""PyTorch port: full SLAM on a bounded grid (run/full_slam.py) against
the JAX package's, on tests/test_full_slam.py's config and log (256^2 at
0.1 m, 120 beams, chunk 16, seed 5) with the hybrid map update (the JAX
update kernel in interpret mode; CPU).

Held equal: keyframe scan indices, the (i, j, accepted) columns of every
loop attempt, n_loops, the loop records' (i, j), the number of frame_cb
calls. Tolerances: attempt scores and peak margins 1e-4 (measured
~1e-6), the attempts' corrections and the loop measurements 5e-3, poses
(keyframes, trajectory, frame_cb chunks) 5e-3 m / 5e-3 rad (measured
~3e-5, the frontend parity's tolerance), chi2 1e-3 relative, maps at most
0.05% of cells off (each by one l_free or l_occ, as the frontend's). The
rebuilders are held bit-exact; the split run to the JAX package's own
resume tolerances (tests/test_resume.py: 1e-3).
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from slam2d_tpu.config import (
    FrontendConfig,
    GraphConfig,
    GridConfig,
    MatcherConfig,
    SensorConfig,
)
from slam2d_tpu.data.synth import SynthWorld, simulate_log
from slam2d_tpu.metrics import ate_rmse
from slam2d_tpu.run import full_slam as jfs
from slam2d_tpu_torch.grid.window import write_window
from slam2d_tpu_torch.run import full_slam as tfs
from torch_parity import pose_error, to_port

torch.set_num_threads(1)

CPU = torch.device("cpu")
POSE_TOL = 5e-3
SCORE_TOL = 1e-4
MAP_CELL_SHARE = 0.0005

CFG = FrontendConfig(
    sensor=SensorConfig(n_beams=120, max_range=12.0),
    grid=GridConfig(
        height=256, width=256, resolution=0.1, ray_samples=128,
        center_x=10.0, center_y=10.0, update_impl="pallas_hybrid",
    ),
    matcher=MatcherConfig(search_xy=0.3, search_theta=0.15, n_theta=13),
    chunk=16,
    bootstrap_dist=2.0,
)
GCFG = GraphConfig(
    max_nodes=128, max_edges=512, keyframe_dist=0.5,
    loop_min_gap=10, loop_radius=2.5, loop_score_accept=0.35,
    gn_iters=10,
)


@functools.cache
def _log():
    wp = np.array(
        [[3.0, 3.0], [3.0, 8.0], [8.0, 8.0], [12.0, 3.5], [16.0, 3.5],
         [17.0, 9.0], [12.0, 14.0], [9.0, 17.0], [4.0, 16.0], [3.0, 10.0],
         [3.0, 3.8]]
    )
    return simulate_log(
        SynthWorld.box_rooms(20.0), wp, CFG.sensor, step=0.15,
        odom_noise_xy=0.02, odom_noise_theta=0.008, seed=5,
    )


@functools.cache
def _runs():
    """JAX's and the port's run over the log, each with a frame_cb that
    keeps what it was given."""
    frames_j, frames_t = [], []
    ref = jfs.run_full_slam(
        _log(), CFG, GCFG,
        frame_cb=lambda m, tr: frames_j.append((np.array(m), np.array(tr))),
    )
    out = tfs.run_full_slam(
        _log(), to_port(CFG), to_port(GCFG), device=CPU,
        frame_cb=lambda m, tr: frames_t.append((m, np.array(tr))),
    )
    return ref, frames_j, out, frames_t


def _assert_maps_close(a, b, name):
    off = float((np.asarray(a) != np.asarray(b)).mean())
    assert off <= MAP_CELL_SHARE, f"{name}: {off:.2%} of cells differ"


def test_run_full_slam_matches_jax():
    ref, _, out, _ = _runs()
    log = _log()
    np.testing.assert_array_equal(out.kf_scan_idx, ref.kf_scan_idx)
    assert out.n_loops == ref.n_loops >= 1
    assert out.loop_attempts.shape == ref.loop_attempts.shape
    np.testing.assert_array_equal(out.loop_attempts[:, [0, 1, 6]],
                                  ref.loop_attempts[:, [0, 1, 6]])
    np.testing.assert_allclose(out.loop_attempts[:, 2:4],
                               ref.loop_attempts[:, 2:4], rtol=0,
                               atol=SCORE_TOL)
    np.testing.assert_allclose(out.loop_attempts[:, [4, 5, 7, 8, 9]],
                               ref.loop_attempts[:, [4, 5, 7, 8, 9]],
                               rtol=0, atol=POSE_TOL)
    np.testing.assert_array_equal(out.loops[:, :2], ref.loops[:, :2])
    np.testing.assert_allclose(out.loops[:, 2:], ref.loops[:, 2:], rtol=0,
                               atol=POSE_TOL)
    for name, a, b in (("keyframes", out.kf_poses, ref.kf_poses),
                       ("trajectory", out.traj, ref.traj)):
        dxy, dth = pose_error(a, b)
        print(f"{name}: max |dxy| {dxy:.3g} m, max |dtheta| {dth:.3g} rad")
        assert dxy <= POSE_TOL and dth <= POSE_TOL
    np.testing.assert_allclose(out.chi2, ref.chi2, rtol=1e-3)
    _assert_maps_close(out.grid.numpy(), ref.grid, "final map")
    # the scenario's own checks (tests/test_full_slam.py)
    gt = log["gt_poses"][out.kf_scan_idx]
    ate_kf = ate_rmse(out.kf_poses, gt, align=False)
    ate_odom = ate_rmse(log["odom"][out.kf_scan_idx], gt, align=False)
    ate_ref = ate_rmse(ref.kf_poses, gt, align=False)
    print(f"kf ATE port {ate_kf:.5f} JAX {ate_ref:.5f} odometry {ate_odom:.5f}")
    assert ate_kf < ate_odom and ate_kf < 0.35
    assert abs(ate_kf - ate_ref) <= POSE_TOL


def test_frame_cb_once_a_chunk_as_jax():
    """frame_cb is called once a chunk, one chunk behind, with the same
    poses and maps as JAX's; each map is a copy the run no longer writes
    into."""
    ref, frames_j, out, frames_t = _runs()
    n_chunks = -(-len(_log()["odom"]) // CFG.chunk)
    assert len(frames_t) == len(frames_j) == n_chunks
    for (m_t, tr_t), (m_j, tr_j) in zip(frames_t, frames_j):
        assert tr_t.shape == tr_j.shape
        dxy, dth = pose_error(tr_t, tr_j)
        assert dxy <= POSE_TOL and dth <= POSE_TOL
        _assert_maps_close(m_t.numpy(), m_j, "frame_cb map")
    ptrs = {m.data_ptr() for m, _ in frames_t}
    assert len(ptrs) == n_chunks and out.grid.data_ptr() not in ptrs


def test_snap_render_poses_matches_jax():
    rng = np.random.default_rng(0)
    for n, n_prev in ((8, 8), (12, 8), (6, 10), (5, 0)):
        mp = rng.normal(0.0, 3.0, (16, 3)).astype(np.float32)
        poses = mp + rng.normal(0.0, 1e-4, mp.shape).astype(np.float32)
        poses[rng.integers(0, 16, 3)] += 0.3
        for args in ((0.01, 0.01), (0.025, 0.002)):
            a = tfs.snap_render_poses(poses, n, mp, n_prev, *args)
            b = jfs.snap_render_poses(poses, n, mp, n_prev, *args)
            np.testing.assert_array_equal(a[0], b[0])
            assert a[1] == b[1]


REBUILD = {
    # 192^2 at 0.1 m, a 10 m sensor: the update window covers the grid
    "whole_grid": (192, 10.0),
    # 256^2 at 0.1 m, a 5 m sensor: 116^2 windows written back in place
    "windowed": (256, 5.0),
}


def _rebuild_case(name):
    size, reach = REBUILD[name]
    cfg = FrontendConfig(
        sensor=SensorConfig(n_beams=60, max_range=reach),
        grid=GridConfig(height=size, width=size, resolution=0.1,
                        ray_samples=96, center_x=6.0, center_y=6.0,
                        update_impl="pallas_hybrid"),
        matcher=MatcherConfig(search_xy=0.25, search_theta=0.12, n_theta=9),
    )
    world = SynthWorld.box_rooms(12.0)
    wp = np.array([[3.0, 3.0], [3.0, 8.0], [8.0, 8.0], [8.0, 3.0]])
    log = simulate_log(world, wp, cfg.sensor, step=0.2, seed=7)
    stride = max(1, len(log["odom"]) // 20)
    poses = np.asarray(log["gt_poses"], np.float32)[::stride][:20]
    scans = np.asarray(log["ranges"], np.float32)[::stride][:20]
    return cfg, poses, scans


def _pad(capacity, poses, scans):
    pb = np.zeros((capacity, 3), np.float32)
    sb = np.zeros((capacity, scans.shape[1]), np.float32)
    mb = np.zeros(capacity, np.float32)
    n = len(poses)
    pb[:n], sb[:n], mb[:n] = poses, scans, 1.0
    return pb, sb, mb


@pytest.mark.parametrize("name", list(REBUILD))
def test_incremental_rebuild_bitexact_after_tracking_writes(name):
    """tests/test_incremental_rebuild.py's correction rounds in the port:
    the incremental rebuild equals a from-scratch rebuild at the snapped
    poses bit for bit, also after the returned map was written into in
    place (as the frontend writes its map) before the next round. The
    from-scratch rebuild agrees with the JAX package's."""
    cfg, poses, scans = _rebuild_case(name)
    capacity, chunk = 32, 8
    port = to_port(cfg)
    inc = tfs.IncrementalRebuilder(port, capacity, chunk=chunk, device=CPU)
    full = tfs.make_rebuild_fn(port, capacity, chunk=chunk, device=CPU)
    rng = np.random.default_rng(0)
    cur = poses
    # rounds 4 and 5 replay from the prefix cached in round 3
    for round_i, k0 in enumerate([0, 14, 6, len(poses), 18, 17]):
        if round_i:
            cur = cur.copy()
            cur[:, :2] += rng.normal(0, 1e-5, (len(cur), 2)).astype(np.float32)
            cur[k0:, :2] += rng.normal(0, 0.05, (len(cur) - k0, 2)).astype(
                np.float32)
            cur[k0:, 2] += rng.normal(0, 0.05, len(cur) - k0).astype(
                np.float32)
        pb, sb, mb = _pad(capacity, cur, scans)
        g_inc = inc(pb, sb, mb, n_active=len(cur))
        pb2, _, _ = _pad(capacity, inc.map_poses[: len(cur)], scans)
        g_ref = full(pb2, sb, mb, n_active=len(cur))
        assert torch.equal(g_inc, g_ref), f"round {round_i}"
        if round_i == 0:
            jax_full = jfs.make_rebuild_fn(cfg, capacity, chunk=chunk)
            _assert_maps_close(g_ref.numpy(),
                               np.asarray(jax_full(pb2, sb, mb, len(cur))),
                               "rebuild against JAX")
        if round_i >= 4:
            assert inc.cache_k == 16
        # tracking writes into the returned map in place
        write_window(g_inc, torch.full((40, 40), 7.5), (10, 20))
        g_inc.add_(0.25)


def test_windowed_map_copies():
    """On a 512^2 grid the frontend writes its map in place (a 288^2 scan
    window, a 272^2 update window): the maps frame_cb is given are the
    map at each chunk's end (bit-exact against run_frontend's over the
    same scans, before any loop), and resuming from a run's checkpoint
    leaves the checkpoint's tensors as they were."""
    from slam2d_tpu_torch.run.frontend import run_frontend

    cfg = to_port(dataclasses.replace(
        CFG, grid=dataclasses.replace(CFG.grid, height=512, width=512)))
    head = {k: v[:64] for k, v in _log().items()}
    tail = {k: v[64:96] for k, v in _log().items()}
    ref = []
    run_frontend(head, cfg, CPU,
                 frame_cb=lambda m, tr: ref.append(m.clone()))
    got = []
    res = tfs.run_full_slam(head, cfg, to_port(GCFG), device=CPU,
                            frame_cb=lambda m, tr: got.append(m))
    assert len(got) == len(ref) == 4
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    keep = [t.clone() for t in res.ckpt["frontend"]]
    tfs.run_full_slam(tail, cfg, to_port(GCFG), device=CPU, resume=res.ckpt,
                      scan_index_offset=64)
    for a, b in zip(res.ckpt["frontend"], keep):
        assert torch.equal(a, b)


def test_split_run_matches_single_run():
    """A run split at a chunk boundary and resumed from the first part's
    checkpoint (as numpy arrays of fullslam_ckpt_template's schema) gives
    the single run's keyframes and loops, and its part-2 trajectory."""
    _, _, full, _ = _runs()
    log = _log()
    T = len(log["odom"])
    cut = (T // 2 // CFG.chunk) * CFG.chunk
    port, gport = to_port(CFG), to_port(GCFG)
    first = {k: v[:cut] for k, v in log.items()}
    second = {k: v[cut:] for k, v in log.items()}
    res_a = tfs.run_full_slam(first, port, gport, device=CPU)
    template = tfs.fullslam_ckpt_template(port, gport)
    assert res_a.ckpt.keys() == template.keys()
    saved = {}
    for k, v in res_a.ckpt.items():
        if isinstance(v, tuple):       # FrontendState, PoseGraph
            v = type(v)(*(x.numpy() for x in v))
            for a, b in zip(v, template[k]):
                assert np.shape(a) == np.shape(b)
        else:
            assert np.shape(v) == np.shape(template[k])
        saved[k] = v
    res_b = tfs.run_full_slam(second, port, gport, device=CPU, resume=saved,
                              scan_index_offset=cut)
    assert res_b.n_loops == full.n_loops
    np.testing.assert_array_equal(res_b.kf_scan_idx, full.kf_scan_idx)
    np.testing.assert_allclose(res_b.kf_poses, full.kf_poses, atol=1e-3)
    np.testing.assert_allclose(res_b.traj, full.traj[cut:], atol=1e-3)
    # the resumed run copied its state: the checkpoint is unchanged
    np.testing.assert_array_equal(saved["frontend"].logodds,
                                  res_a.ckpt["frontend"].logodds.numpy())


def test_run_full_slam_schur_matches_jax():
    """optimizer="schur" (graph/schur.py, 4 blocks) against the JAX
    package's run at the same config and log: the decisions equal, poses
    and chi2 as the dense run's tolerances."""
    ref = jfs.run_full_slam(_log(), CFG, GCFG, optimizer="schur")
    out = tfs.run_full_slam(_log(), to_port(CFG), to_port(GCFG),
                            optimizer="schur", device=CPU)
    np.testing.assert_array_equal(out.kf_scan_idx, ref.kf_scan_idx)
    assert out.n_loops == ref.n_loops >= 1
    np.testing.assert_array_equal(out.loop_attempts[:, [0, 1, 6]],
                                  ref.loop_attempts[:, [0, 1, 6]])
    for a, b in ((out.kf_poses, ref.kf_poses), (out.traj, ref.traj)):
        dxy, dth = pose_error(a, b)
        assert dxy <= POSE_TOL and dth <= POSE_TOL
    np.testing.assert_allclose(out.chi2, ref.chi2, rtol=1e-3)


def _closers(optimizer):
    """The JAX package's and the port's LoopCloser over tests/test_graph.py's
    square loop graph (17 keyframes)."""
    from test_graph import _square_loop_graph

    g, _, _ = _square_loop_graph(drift=0.15)
    n = int(g.n_nodes)
    gcfg = dataclasses.replace(GCFG, max_nodes=64, max_edges=128)
    kf = [np.array(p, np.float32) for p in np.asarray(g.poses[:n])]
    out = []
    for pkg, c, gc in ((jfs, CFG, gcfg), (tfs, to_port(CFG), to_port(gcfg))):
        graph = pkg.se2_graph.HostGraph(gc)
        for p in kf:
            graph.add_node(p)
        for e in range(int(g.n_edges)):
            i, j = np.asarray(g.edges_ij[e])
            graph.add_edge(int(i), int(j), np.asarray(g.edges_z[e]),
                           np.asarray(g.edges_omega[e]))
        kw = {} if pkg is jfs else {"device": CPU}
        out.append(pkg.LoopCloser(
            c, gc, pkg.default_loop_matcher(gc), pkg.default_submap_grid(c),
            3, graph, [p.copy() for p in kf], [None] * n, list(range(n)),
            np.zeros((n, 8), np.float32), np.zeros((n, 3), np.float32),
            optimizer, 200.0, 0, lambda T: None, [], **kw,
        ))
    return out


@pytest.mark.parametrize("optimizer", ["dense", "schur"])
def test_loop_prune_as_jax(optimizer):
    """A false loop edge (3 m off, as tests/test_robust_edges.py's) flagged
    by the chi^2 prune: the same solved poses and flags as the JAX
    package's; "dense" solves again with the edge masked (one host read),
    "schur" does not (no read: the flags reach the HostGraph at the
    finalize)."""
    jc, tc = _closers(optimizer)
    z = np.array([3.0, 0.0, 0.0], np.float32)
    ref = jfs.jax.device_get(jc._dispatch_optimize(14, 1, z, 0.9))
    reads = tfs.fetch.reads
    out = tc._dispatch_optimize(14, 1, z, 0.9)
    assert tfs.fetch.reads - reads == (optimizer == "dense")
    np.testing.assert_array_equal(out[2].numpy(), np.asarray(ref[2]))
    assert out[2].numpy()[tc.graph.n_edges - 1]
    dxy, dth = pose_error(out[0].numpy(), np.asarray(ref[0]))
    assert dxy <= POSE_TOL and dth <= POSE_TOL
    np.testing.assert_allclose(float(out[1]), float(ref[1]), rtol=1e-3,
                               atol=1e-6)


@pytest.mark.parametrize("optimizer", ["schur_sharded", "sparse", "hier"])
def test_unported_optimizers_raise(optimizer):
    with pytest.raises(NotImplementedError, match="not ported"):
        tfs.run_full_slam(_log(), to_port(CFG), to_port(GCFG),
                          optimizer=optimizer, device=CPU)


def test_auto_beyond_dense_keyframes_raises():
    """optimizer="auto" past 1024 keyframes, where the JAX package picks
    its hierarchical solver, raises at the accept, before the graph
    changes."""
    port = to_port(dataclasses.replace(GCFG, max_nodes=2048))
    n = tfs.DENSE_MAX_KEYFRAMES + 1
    kf = [np.array([0.1 * k, 0.0, 0.0], np.float32) for k in range(n)]
    graph = tfs.se2_graph.HostGraph(port)
    closer = tfs.LoopCloser(
        to_port(CFG), port, tfs.default_loop_matcher(port),
        tfs.default_submap_grid(to_port(CFG)), 3, graph, kf, [None] * n,
        list(range(n)), np.zeros((n, 8), np.float32),
        np.zeros((n, 3), np.float32), "auto", 200.0, 0, lambda T: None, [],
        device=CPU,
    )
    with pytest.raises(NotImplementedError, match="hier"):
        closer._dispatch_optimize(0, n - 1, np.zeros(3, np.float32), 0.9)
    assert graph.n_edges == 0 and closer.n_loops == 0
