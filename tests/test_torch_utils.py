"""PyTorch port: checkpoints (utils/checkpoint.py), profiling
(utils/profiling.py and full SLAM's ACCEPT_TIMER) and the metrics log
(utils/metrics_logger.py), on the CPU.

- Checkpoints: every leaf restored bit for bit with its dtype and shape
  (float32 and bfloat16 FastSLAM states, a frontend state, full SLAM's
  ckpt dict); a restore into a template of another shape or dtype, or of
  another tree, raises; the file holds no pickle.
- PhaseTimer: phases counted and reported.
- ACCEPT_TIMER: a full SLAM run that closes a loop records the JAX
  package's three accept phases, and leaves the result bit-identical to
  a run without the timer.
- The metrics log writes the JAX package's JSONL records (equal but for
  the wall-clock field `t`).
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from slam2d_tpu.utils.metrics_logger import MetricsLogger as JLogger
from slam2d_tpu_torch.config import PFConfig
from slam2d_tpu_torch.pf import fastslam as tfs
from slam2d_tpu_torch.run import full_slam as tfull
from slam2d_tpu_torch.run.frontend import frontend_init
from slam2d_tpu_torch.utils import checkpoint
from slam2d_tpu_torch.utils.metrics_logger import MetricsLogger
from slam2d_tpu_torch.utils.profiling import PhaseTimer
from test_torch_full_slam import CFG as FULL_CFG
from test_torch_full_slam import GCFG as FULL_GCFG
from test_torch_full_slam import _log as full_log
from torch_parity import PF_CFG, to_port

torch.set_num_threads(1)
CPU = torch.device("cpu")
TCFG = to_port(PF_CFG)


def _assert_trees_equal(a, b):
    la, lb = checkpoint._leaves(a), checkpoint._leaves(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (p, x), (_, y) in zip(la, lb):
        assert type(x) is type(y) or (
            isinstance(x, np.generic) and isinstance(y, np.generic)), p
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and x.shape == y.shape, p
            assert x.device == y.device, p
            if x.dtype == torch.bfloat16:
                x, y = x.view(torch.int16), y.view(torch.int16)
            assert torch.equal(x, y), p
        else:
            assert np.asarray(x).dtype == np.asarray(y).dtype, p
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def _pf_state(map_dtype, seed=0):
    pf = PFConfig(n_particles=4, map_dtype=map_dtype)
    state = tfs.fastslam_init(TCFG, pf, CPU, start_pose=[1.0, 2.0, 0.3])
    rng = np.random.default_rng(seed)
    maps = torch.tensor(rng.normal(0, 2, tuple(state.logodds.shape)),
                        dtype=torch.float32).to(state.logodds.dtype)
    return pf, state._replace(
        logodds=maps, log_w=torch.tensor(rng.normal(size=4),
                                         dtype=torch.float32),
        dist=torch.tensor(4.5),
    )


@pytest.mark.parametrize("map_dtype", ["float32", "bfloat16"])
def test_pf_state_round_trip(tmp_path, map_dtype):
    pf, state = _pf_state(map_dtype)
    path = checkpoint.save_state(str(tmp_path / "ckpt"), state)
    tmpl = tfs.pf_state_template(TCFG, pf)
    assert tmpl.logodds.device.type == "meta"
    back = checkpoint.load_state(path, tmpl, device=CPU)
    _assert_trees_equal(back, state)
    meta = json.loads((tmp_path / "ckpt" / "tree.json").read_text())
    assert meta["leaves"][0] == {"path": "logodds", "dtype": map_dtype,
                                 "shape": [4, 224, 224]}
    # no pickle: the arrays load with allow_pickle=False
    with np.load(tmp_path / "ckpt" / "arrays.npz", allow_pickle=False) as z:
        assert len(z.files) == len(tfs.PFState._fields)


def test_frontend_state_round_trip_to_the_template_device(tmp_path):
    state = frontend_init(TCFG, CPU, start_pose=[1.0, 2.0, 0.3])
    state = state._replace(dist=torch.tensor(4.5),
                           logodds=torch.randn(tuple(state.logodds.shape)))
    path = checkpoint.save_state(str(tmp_path / "f"), state)
    _assert_trees_equal(checkpoint.load_state(path, frontend_init(TCFG, CPU)),
                        state)


def test_restore_checks_shape_dtype_and_tree(tmp_path):
    pf, state = _pf_state("float32")
    path = checkpoint.save_state(str(tmp_path / "c"), state)
    bigger = dataclasses.replace(pf, n_particles=5)
    bf16 = dataclasses.replace(pf, map_dtype="bfloat16")
    for tmpl in (tfs.pf_state_template(TCFG, bigger),
                 tfs.pf_state_template(TCFG, bf16),
                 frontend_init(TCFG, CPU)):
        with pytest.raises(ValueError):
            checkpoint.load_state(path, tmpl, device=CPU)


@pytest.fixture(scope="module")
def full_runs():
    """Full SLAM with the sampled-ray update over the full-SLAM test log:
    once plain, once with ACCEPT_TIMER installed."""
    cfg = to_port(dataclasses.replace(
        FULL_CFG, grid=dataclasses.replace(FULL_CFG.grid,
                                           update_impl="sparse")))
    gcfg = to_port(FULL_GCFG)
    log = full_log()
    res = tfull.run_full_slam(log, cfg, gcfg, device=CPU)
    timer = PhaseTimer()
    tfull.ACCEPT_TIMER = timer
    try:
        timed = tfull.run_full_slam(log, cfg, gcfg, device=CPU)
    finally:
        tfull.ACCEPT_TIMER = None
    return cfg, gcfg, log, res, timed, timer


def test_accept_timer_records_the_accept_phases(full_runs):
    _, _, _, res, timed, timer = full_runs
    assert res.n_loops >= 1
    assert set(timer.counts) == {"accept/graph_to_device",
                                 "accept/optimize+fetch",
                                 "accept/retro_correct_host"}
    # each accept: one graph copy, its solve and its read, one retro pass
    assert timer.counts["accept/graph_to_device"] == res.n_loops
    assert timer.counts["accept/retro_correct_host"] == res.n_loops
    assert timer.counts["accept/optimize+fetch"] == 2 * res.n_loops
    assert "accept/optimize+fetch" in timer.report()
    np.testing.assert_array_equal(timed.traj, res.traj)
    np.testing.assert_array_equal(timed.kf_poses, res.kf_poses)


def test_full_slam_ckpt_round_trip(tmp_path, full_runs):
    cfg, gcfg, _, res, _, _ = full_runs
    path = checkpoint.save_state(str(tmp_path / "full"), res.ckpt)
    back = checkpoint.load_state(path, tfull.fullslam_ckpt_template(cfg, gcfg))
    for (p, x), (_, y) in zip(checkpoint._leaves(back),
                              checkpoint._leaves(res.ckpt)):
        y = y.numpy() if isinstance(y, torch.Tensor) else np.asarray(y)
        np.testing.assert_array_equal(np.asarray(x), y, err_msg=p)


def test_phase_timer():
    pt = PhaseTimer()
    for _ in range(2):
        with pt.phase("a"):
            pass
    with pt.phase("b"):
        pass
    assert pt.counts == {"a": 2, "b": 1}
    assert "a" in pt.report() and "b" in pt.report()


def test_metrics_logger_equals_jax(tmp_path):
    rows = [dict(score=0.9, n_eff=31.5), dict(score=0.8, chi2=1.25)]
    for cls, d in ((MetricsLogger, "p"), (JLogger, "j")):
        with cls(str(tmp_path / d), tensorboard=False) as ml:
            for i, r in enumerate(rows):
                ml.log(i, **r)

    def records(d):
        lines = (tmp_path / d / "metrics.jsonl").read_text().splitlines()
        return [{k: v for k, v in json.loads(x).items() if k != "t"}
                for x in lines]

    assert records("p") == records("j") == [
        {"step": i, **r} for i, r in enumerate(rows)]
    with MetricsLogger(str(tmp_path / "tb"), tensorboard=True) as ml:
        ml.log(0, x=1.0)
    assert os.path.exists(tmp_path / "tb" / "metrics.jsonl")
