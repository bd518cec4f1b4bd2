"""PyTorch port: tests/test_robustness.py's driver-level probes (CPU).

The port's drivers run the same probes as the JAX package's: a log whose
length is no multiple of the chunk and a single-scan log (the padded
tail), a stretch of all-max-range scans (no hit) mid-log in the frontend
and in FastSLAM, localization with recovery on an odd length, a
blackout and a single scan, and global relocalization on a hitless and
an all-NaN scan. Each is held to the JAX file's expectations: finite
outputs of the right shapes, the map integrated, tracking back after the
blackout, no recovery event on the blackout; the two degenerate scans
give JAX's pose and score exactly (the same numpy map to both).
"""

import numpy as np
import pytest
import torch

import test_robustness as jrob
from slam2d_tpu.match.global_loc import global_localize as jax_global_localize
from slam2d_tpu.run import frontend as jfe
from slam2d_tpu_torch.match.global_loc import global_localize
from slam2d_tpu_torch.run import frontend as tfe
from slam2d_tpu_torch.run.fastslam_run import run_fastslam
from torch_parity import to_port

torch.set_num_threads(1)

CPU = torch.device("cpu")
CFG = to_port(jrob.CFG)


def _jax_map():
    state, _, _ = jfe.run_frontend(jrob._log(), jrob.CFG)
    return np.array(state.logodds)


def test_log_length_not_divisible_by_chunk():
    log = jrob._log()
    T = (len(log["odom"]) // CFG.chunk - 1) * CFG.chunk + 3
    log = {k: v[:T] for k, v in log.items()}
    state, traj, scores = tfe.run_frontend(log, CFG, CPU)
    assert traj.shape == (T, 3) and scores.shape == (T,)
    assert np.isfinite(traj).all() and np.isfinite(scores).all()
    assert torch.isfinite(state.logodds).all()


def test_single_scan_log():
    state, traj, scores = tfe.run_frontend(jrob._log(n=1), CFG, CPU)
    assert traj.shape == (1, 3) and scores.shape == (1,)
    assert np.isfinite(traj).all()
    lo = state.logodds
    assert torch.isfinite(lo).all() and bool((lo < -0.1).any())


def test_all_max_range_scans_mid_log_stay_finite():
    log = jrob._log()
    ranges = np.array(log["ranges"], np.float32)
    ranges[10:16, :] = CFG.sensor.max_range
    log = dict(log, ranges=ranges)
    state, traj, scores = tfe.run_frontend(log, CFG, CPU)
    assert np.isfinite(traj).all() and np.isfinite(scores).all()
    assert torch.isfinite(state.logodds).all()
    err = np.linalg.norm(traj[-1, :2] - log["gt_poses"][-1, :2])
    assert err < 1.0


def test_fastslam_all_max_range_stays_finite():
    log = jrob._log(n=24)
    ranges = np.array(log["ranges"], np.float32)
    ranges[8:12, :] = CFG.sensor.max_range
    log = dict(log, ranges=ranges)
    pf = to_port(jrob.PFConfig(n_particles=8))
    _, traj, n_eff, scores = run_fastslam(log, CFG, pf, CPU, seed=0)
    assert np.isfinite(np.asarray(traj)).all()
    assert np.isfinite(np.asarray(n_eff)).all()


@pytest.mark.parametrize("probe", ["odd_length", "blackout", "single_scan"])
def test_localization_robustness_probes(probe):
    prebuilt = _jax_map()
    K = CFG.chunk
    if probe == "odd_length":
        log = jrob._log(n=2 * K + 3)
    elif probe == "blackout":
        # all-max-range scans: the matcher sees no valid beam
        log = jrob._log(n=3 * K)
        log["ranges"] = np.array(log["ranges"], np.float32)
        log["ranges"][K : 2 * K] = CFG.sensor.max_range
    else:
        log = jrob._log(n=1)
    _, traj, scores, events = tfe.run_localization(
        log, CFG, prebuilt, CPU, recover=True)
    assert traj.shape == (len(log["odom"]), 3)
    assert np.isfinite(traj).all() and np.isfinite(scores).all()
    _, _, _, jev = jfe.run_localization(log, jrob.CFG, prebuilt, recover=True)
    assert [e["scan"] for e in events] == [e["scan"] for e in jev]
    if probe != "odd_length":
        assert events == []


@pytest.mark.parametrize("kind", ["hitless", "nan"])
def test_global_localize_degenerate_scans(kind):
    prebuilt = _jax_map()
    n = CFG.sensor.n_beams
    r = np.full(n, CFG.sensor.max_range if kind == "hitless" else np.nan,
                np.float32)
    pose, score = global_localize(
        torch.from_numpy(prebuilt), torch.from_numpy(r), CFG.grid,
        CFG.matcher, CFG.sensor, n_theta=8, theta_chunk=4)
    assert torch.isfinite(pose).all() and torch.isfinite(score)
    jpose, jscore = jax_global_localize(
        prebuilt, r, jrob.CFG.grid, jrob.CFG.matcher, jrob.CFG.sensor,
        n_theta=8, theta_chunk=4)
    np.testing.assert_array_equal(pose.numpy(), np.asarray(jpose))
    assert float(score) == float(jscore)
