"""PyTorch port: the frontend slice against the JAX frontend with the hybrid
map update (CPU; the JAX update kernel runs in interpret mode).

Tolerances: per-scan |dxy| <= 5e-3 m and |dtheta| <= 5e-3 rad (measured
near 1e-5: the two differ by float32 rounding in cos/sin/atan2, and by
the occasional endpoint cell that this moves), ATE within 5 mm of JAX's.
"""

import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from slam2d_tpu.metrics import ate_rmse
from slam2d_tpu.run import frontend as jfe
from slam2d_tpu_torch.run import frontend as tfe
from torch_parity import e2e_log, frontend_cfg, pose_error, to_port

torch.set_num_threads(1)

CPU = torch.device("cpu")
POSE_TOL = 5e-3


def _assert_states_close(ts, js_arrays):
    t = tfe.state_to_numpy(ts)
    lo_t, lo_j = t.logodds, js_arrays[0]
    assert (lo_t != lo_j).mean() <= 0.0005
    # a differing map cell moves the blurred field around it
    assert (np.abs(t.search_space - js_arrays[1]) > 1e-5).mean() <= 0.005
    for a, b in zip(t[2:], js_arrays[2:]):
        np.testing.assert_allclose(a, b, rtol=0, atol=POSE_TOL)


@pytest.mark.parametrize("size", [256, 512])
def test_slice_matches_jax(size):
    cfg = frontend_cfg(size)
    log = e2e_log()
    js, jt, jsc = jfe.run_frontend(log, cfg)
    ts, tt, tsc = tfe.run_frontend(log, to_port(cfg), CPU)
    assert tt.shape == jt.shape and np.isfinite(tt).all()
    dxy, dth = pose_error(tt, jt)
    print(f"{size}^2: max |dxy| {dxy:.3g} m, max |dtheta| {dth:.3g} rad")
    assert dxy <= POSE_TOL and dth <= POSE_TOL
    # the same scans were matched, with the same scores
    np.testing.assert_array_equal(tsc == -1.0, jsc == -1.0)
    np.testing.assert_allclose(tsc, jsc, rtol=0, atol=1e-4)
    gt = log["gt_poses"]
    ate_t = ate_rmse(tt, gt, align=False)
    ate_j = ate_rmse(jt, gt, align=False)
    ate_odom = ate_rmse(log["odom"], gt, align=False)
    print(f"ATE port {ate_t:.4f} JAX {ate_j:.4f} odometry {ate_odom:.4f}")
    assert ate_t < 0.10 and ate_t < ate_odom and abs(ate_t - ate_j) <= 0.005
    _assert_states_close(ts, [np.asarray(x) for x in js])


def test_state_carried_across_from_jax():
    cfg = frontend_cfg(512, chunk=20)
    log = e2e_log()
    head = {k: v[:40] for k, v in log.items()}
    tail = {k: v[40:60] for k, v in log.items()}
    js, _, _ = jfe.run_frontend(head, cfg)
    arrays = [np.array(x) for x in js]  # copies: the JAX runner donates js
    ts = tfe.state_from_numpy(arrays, CPU)
    for a, b in zip(tfe.state_to_numpy(ts), arrays):
        np.testing.assert_array_equal(a, b)
    js2, jt, _ = jfe.run_frontend(tail, cfg, state=js)
    ts2, tt, _ = tfe.run_frontend(tail, to_port(cfg), CPU, state=ts)
    dxy, dth = pose_error(tt, jt)
    print(f"carried state: max |dxy| {dxy:.3g} m, max |dtheta| {dth:.3g} rad")
    assert dxy <= POSE_TOL and dth <= POSE_TOL
    _assert_states_close(ts2, [np.asarray(x) for x in js2])


def test_port_runs_without_jax():
    code = textwrap.dedent(
        """
        import sys
        import torch
        import slam2d_tpu_torch
        from slam2d_tpu_torch.run.frontend import frontend_init, frontend_step
        cfg = slam2d_tpu_torch.FrontendConfig(
            sensor=slam2d_tpu_torch.SensorConfig(n_beams=32, max_range=3.0),
            grid=slam2d_tpu_torch.GridConfig(height=64, width=64),
            matcher=slam2d_tpu_torch.MatcherConfig(search_xy=0.2, n_theta=5),
        )
        state = frontend_init(cfg, torch.device("cpu"))
        state, (pose, score) = frontend_step(
            state, torch.tensor([0.1, 0.0, 0.0]), torch.full((32,), 2.0), cfg
        )
        assert bool(torch.isfinite(pose).all()) and state.logodds.any()
        print("jax" in sys.modules, "slam2d_tpu" in sys.modules)
        """
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=300, cwd=root,
    )
    assert out.returncode == 0, out.stderr
    # neither JAX nor the JAX package was imported
    assert out.stdout.strip().splitlines()[-1] == "False False"


def test_localize_only_step_leaves_the_map():
    """A localize_only step: no bootstrap (it matches from the first metre
    on), and the map, its search space and last_map_pose come back
    untouched."""
    cfg = to_port(dataclasses.replace(frontend_cfg(256), localize_only=True))
    state = tfe.frontend_init(cfg, CPU)
    kept = [t.clone() for t in state]
    matches = tfe.frontend_step.matches
    odom = torch.tensor([cfg.match_min_motion, 0.0, 0.0])
    new, (pose, score) = tfe.frontend_step(
        state, odom, torch.full((180,), 2.0), cfg
    )
    assert tfe.frontend_step.matches == matches + 1
    for i in (0, 1, 5):   # logodds, search_space, last_map_pose
        assert torch.equal(new[i], kept[i])
    assert torch.equal(new.prev_odom, odom) and bool(torch.isfinite(pose).all())
