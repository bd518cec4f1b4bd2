"""PyTorch port: localization on a fixed map (run_localization), the
offline runner (run_frontend_offline) and the frame callback of
run_frontend, against the JAX package's run/frontend.py (CPU).

The map is built once by the JAX frontend on tests/test_localize.py's
config and mapping log, and the same numpy map goes to both packages.
Tolerances: the trajectory's ATE within 5 mm of JAX's (as the frontend
slice, tests/test_torch_frontend.py), the same scans skipped (score
exactly -1.0), the map bit-identical afterwards.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import test_localize as jloc
from slam2d_tpu.metrics import ate_rmse
from slam2d_tpu.run import frontend as jfe
from slam2d_tpu_torch.run import frontend as tfe
from torch_parity import to_port

torch.set_num_threads(1)

CPU = torch.device("cpu")
ATE_TOL = 5e-3
# the offline and callback runs integrate scans: the hybrid update, which
# the JAX frontend runs as its kernel (interpret mode here) and the port
# ports; tests/test_localize.py's CFG would let JAX pick its sparse update
MAP_CFG = dataclasses.replace(
    jloc.CFG,
    grid=dataclasses.replace(jloc.CFG.grid, update_impl="pallas_hybrid"),
)
OFFLINE_SCANS = 100   # not a multiple of the chunk (16): a padded tail


@functools.cache
def _map_and_log():
    """(JAX's map of the mapping log, the localization log)."""
    map_log, loc_log = jloc._logs()
    state, _, _ = jfe.run_frontend(map_log, jloc.CFG)
    return np.array(state.logodds), loc_log


def _ate(traj, log):
    return float(ate_rmse(traj, log["gt_poses"], align=False))


@pytest.mark.parametrize("map_kind", ["numpy", "tensor"])
def test_localization_matches_jax(map_kind):
    prebuilt, log = _map_and_log()
    keep = prebuilt.copy()
    _, jt, jsc, jev = jfe.run_localization(log, jloc.CFG, prebuilt)
    given = prebuilt if map_kind == "numpy" else torch.from_numpy(prebuilt)
    tfe.frontend_step.host_syncs = 0
    tfe.frontend_step.matches = tfe.frontend_step.updates = 0
    ts, tt, tsc, tev = tfe.run_localization(log, to_port(jloc.CFG), given, CPU)
    # the gates stay on the device: no host read (host_syncs counts reads
    # of CUDA tensors; on the CPU the step branches on a CPU read, which
    # drains no stream); the device counters count every matched scan (the
    # padded tail repeats the last odometry, so it never matches) and no
    # update
    assert tfe.frontend_step.host_syncs == 0
    assert tfe.frontend_step.matches == int((tsc != -1.0).sum()) > 0
    assert tfe.frontend_step.updates == 0
    assert tt.shape == jt.shape and np.isfinite(tt).all()
    assert tev == jev == []
    np.testing.assert_array_equal(tsc == -1.0, jsc == -1.0)
    ate_t, ate_j, ate_odom = _ate(tt, log), _ate(jt, log), _ate(log["odom"], log)
    print(f"ATE port {ate_t:.5f} JAX {ate_j:.5f} odometry {ate_odom:.5f}")
    assert abs(ate_t - ate_j) <= ATE_TOL
    assert ate_t < ate_odom and ate_t < 0.25
    # the caller's map and the state's come back bit-identical
    np.testing.assert_array_equal(prebuilt, keep)
    np.testing.assert_array_equal(ts.logodds.numpy(), keep)


def test_localization_state_is_not_the_callers_map():
    prebuilt, log = _map_and_log()
    given = torch.from_numpy(prebuilt.copy())
    part = {k: v[:20] for k, v in log.items()}
    ts, _, _, _ = tfe.run_localization(part, to_port(jloc.CFG), given, CPU)
    assert ts.logodds.data_ptr() != given.data_ptr()
    # the search space is built once, on the whole map
    assert ts.search_space.shape == given.shape


def test_localization_rejects_a_map_of_another_shape():
    prebuilt, log = _map_and_log()
    with pytest.raises(ValueError):
        tfe.run_localization(log, to_port(jloc.CFG), prebuilt[:-1], CPU)


def _offline_log():
    map_log, _ = jloc._logs()
    return {k: np.asarray(v)[:OFFLINE_SCANS] for k, v in map_log.items()}


def test_offline_equals_streaming_and_jax():
    log = _offline_log()
    cfg = to_port(MAP_CFG)
    s_on, t_on, sc_on = tfe.run_frontend(log, cfg, CPU)
    s_off, t_off, sc_off = tfe.run_frontend_offline(log, cfg, CPU)
    assert t_off.shape == (OFFLINE_SCANS, 3)
    np.testing.assert_array_equal(t_off, t_on)
    np.testing.assert_array_equal(sc_off, sc_on)
    for a, b in zip(s_off, s_on):
        assert torch.equal(a, b)
    _, jt, jsc = jfe.run_frontend_offline(log, MAP_CFG)
    np.testing.assert_array_equal(sc_off == -1.0, jsc == -1.0)
    ate_t, ate_j = _ate(t_off, log), _ate(jt, log)
    print(f"offline ATE port {ate_t:.5f} JAX {ate_j:.5f}")
    assert abs(ate_t - ate_j) <= ATE_TOL


def test_frame_cb_once_a_chunk_like_jax():
    log = _offline_log()
    calls_t, calls_j = [], []

    def cb_t(logodds, traj_chunk):
        assert isinstance(logodds, torch.Tensor)
        calls_t.append((logodds.clone(), traj_chunk))

    def cb_j(logodds, traj_chunk):
        calls_j.append(np.asarray(traj_chunk))

    tfe.frontend_step.host_syncs = 0
    state, traj, _ = tfe.run_frontend(log, to_port(MAP_CFG), CPU,
                                      frame_cb=cb_t)
    syncs = tfe.frontend_step.host_syncs
    _, traj_plain, _ = tfe.run_frontend(log, to_port(MAP_CFG), CPU)
    # the callback changes nothing: the same trajectory, and no host read
    # counted (its one map read a chunk is the caller's, and the gates
    # stay on the device)
    np.testing.assert_array_equal(traj, traj_plain)
    assert tfe.frontend_step.host_syncs == 2 * syncs == 0
    jfe.run_frontend(log, MAP_CFG, frame_cb=cb_j)
    K = MAP_CFG.chunk
    assert len(calls_t) == len(calls_j) == -(-OFFLINE_SCANS // K)
    assert [len(c[1]) for c in calls_t] == [len(c) for c in calls_j]
    np.testing.assert_array_equal(np.concatenate([c[1] for c in calls_t]),
                                  traj)
    # the last call sees the final map
    assert torch.equal(calls_t[-1][0], state.logodds)
