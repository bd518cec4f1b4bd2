"""PyTorch port: the tiled frontend (slam2d_tpu_torch/run/frontend_tiled.py)
against the JAX package's slam2d_tpu/run/frontend_tiled.py (CPU; the
JAX update kernel runs in interpret mode).

The config and log are tests/test_tiled_frontend.py's (128^2 tiles at
0.1 m: a 256^2 window over three tiles a side), with the hybrid map
update, which the JAX frontend runs as its kernel on its accelerator and
the port ports (on the CPU JAX would pick its sparse update).
Tolerances, as the fixed-grid frontend's (tests/test_torch_frontend.py):
per-scan |dxy| and |dtheta| <= 5e-3 (measured ~1e-5), ATE within 5 mm of
JAX's, the same scans skipped (score exactly -1.0), the same active
coords in the same slots, log-odds tiles with at most 0.05% of their
cells off, each by one l_free or l_occ at most (the hybrid update's), the
search-space tiles with at most 0.5% of their cells off by more than 1e-5
(a flipped map cell moves the blurred field around it). One step from a
state carried across from JAX: pose within 5e-3, score within 1e-4.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from slam2d_tpu.config import FrontendConfig, GridConfig, MatcherConfig, SensorConfig
from slam2d_tpu.data.synth import SynthWorld, simulate_log
from slam2d_tpu.grid import tiles as jtiles
from slam2d_tpu.metrics import ate_rmse
from slam2d_tpu.run import frontend_tiled as jft
from slam2d_tpu_torch.grid import tiles as ttiles
from slam2d_tpu_torch.run import frontend_tiled as tft
from torch_parity import pose_error, to_port

torch.set_num_threads(1)

CPU = torch.device("cpu")
POSE_TOL = 5e-3
ATE_TOL = 5e-3
SENSOR = SensorConfig(n_beams=120, max_range=10.0)
CFG = FrontendConfig(
    sensor=SENSOR,
    grid=GridConfig(resolution=0.1, ray_samples=100,
                    update_impl="pallas_hybrid"),  # params only
    matcher=MatcherConfig(search_xy=0.25, search_theta=0.12, n_theta=9),
    chunk=16,
    bootstrap_dist=2.0,
)
JTCFG = jtiles.TileConfig(tile=128, n_slots=24, resolution=0.1)
TTCFG = ttiles.TileConfig(tile=128, n_slots=24, resolution=0.1)
CARRY_SCANS = 48     # a multiple of the chunk: no padded tail


@functools.cache
def _log():
    world = SynthWorld.box_rooms(20.0)
    wp = np.array([[3.0, 3.0], [3.0, 8.0], [8.0, 8.0], [12.0, 3.5],
                   [16.0, 3.5]])
    return simulate_log(world, wp, SENSOR, step=0.15, odom_noise_xy=0.01,
                        odom_noise_theta=0.004, seed=7)


@functools.cache
def _jax_run():
    state, traj, scores = jft.run_tiled_frontend(_log(), CFG, JTCFG)
    return jax.tree.map(np.array, state), traj, scores


@functools.cache
def _port_run():
    tft.tiled_frontend_step.host_syncs = 0
    state, traj, scores = tft.run_tiled_frontend(
        _log(), to_port(CFG), TTCFG, CPU)
    return state, traj, scores, tft.tiled_frontend_step.host_syncs


def _active(coords):
    return np.flatnonzero(np.asarray(coords)[:-1, 0] > ttiles.FREE_SLOT)


def _assert_pools_close(ts, js):
    """Log-odds and search-space tiles of the active slots, as the module
    docstring states; the trash slot is left out."""
    t = tft.tiled_state_to_numpy(ts)
    np.testing.assert_array_equal(t.grid.coords, js.grid.coords)
    np.testing.assert_array_equal(t.sgrid.coords, js.sgrid.coords)
    act = _active(js.grid.coords)
    lo_t, lo_j = t.grid.tiles[act], js.grid.tiles[act]
    diff = np.abs(lo_t - lo_j)
    off = diff > 1e-5
    step = max(abs(CFG.grid.l_free), abs(CFG.grid.l_occ))
    print(f"log-odds cells off {off.mean():.3g}, max {diff.max():.3g}")
    assert off.mean() <= 0.0005 and diff.max() <= step + 1e-5
    s_off = np.abs(t.sgrid.tiles[act] - js.sgrid.tiles[act]) > 1e-5
    print(f"search-space cells off {s_off.mean():.3g}")
    assert s_off.mean() <= 0.005


def test_tiled_window_cells_matches_jax():
    from slam2d_tpu.config import SensorConfig as JS
    for res, rng_m, sxy in ((0.1, 10.0, 0.25), (0.05, 12.0, 0.3),
                            (0.05, 30.0, 0.4)):
        jt_ = jtiles.TileConfig(resolution=res)
        m = MatcherConfig(search_xy=sxy)
        s = JS(max_range=rng_m)
        assert tft.tiled_window_cells(
            ttiles.TileConfig(resolution=res), to_port(s), to_port(m)
        ) == jft.tiled_window_cells(jt_, s, m)
    # bench.py's sensor and matcher at 0.05 m: a 544^2 window
    from slam2d_tpu_torch.run.bench_configs import tiled_bench_config
    cfg, tcfg = tiled_bench_config()
    assert tft.tiled_window_cells(tcfg, cfg.sensor, cfg.matcher) == 544


def test_run_matches_jax():
    js, jt, jsc = _jax_run()
    ts, tt, tsc, syncs = _port_run()
    log = _log()
    T, K = len(tt), CFG.chunk
    assert tt.shape == jt.shape and np.isfinite(tt).all()
    dxy, dth = pose_error(tt, jt)
    print(f"tiled: max |dxy| {dxy:.3g} m, max |dtheta| {dth:.3g} rad")
    assert dxy <= POSE_TOL and dth <= POSE_TOL
    np.testing.assert_array_equal(tsc == -1.0, jsc == -1.0)
    gt = log["gt_poses"]
    ate_t, ate_j = ate_rmse(tt, gt, align=False), ate_rmse(jt, gt, align=False)
    ate_odom = ate_rmse(log["odom"], gt, align=False)
    print(f"ATE port {ate_t:.5f} JAX {ate_j:.5f} odometry {ate_odom:.5f}")
    assert abs(ate_t - ate_j) <= ATE_TOL and ate_t < ate_odom
    assert len(_active(js.grid.coords)) >= 4
    _assert_pools_close(ts, js)
    # the gates stay on the device: the forecast's pose once a chunk
    n_chunks = -(-T // K)
    assert syncs == n_chunks


def test_state_from_and_to_numpy_round_trip():
    js, _, _ = _jax_run()
    ts, table = tft.tiled_state_from_numpy(js, TTCFG, CPU)
    back = tft.tiled_state_to_numpy(ts)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(js)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert ts.grid.coords.dtype == torch.int32
    np.testing.assert_array_equal(table.coords, js.grid.coords)
    assert len(table.slot_of) == len(_active(js.grid.coords))


@functools.cache
def _carried_jax_state():
    head = {k: v[:CARRY_SCANS] for k, v in _log().items()}
    state, _, _ = jft.run_tiled_frontend(head, CFG, JTCFG)
    return jax.tree.map(np.array, state)


def test_steps_from_a_state_carried_across_from_jax():
    """Scans CARRY_SCANS.. stepped one at a time by both packages from the
    JAX state after the first CARRY_SCANS scans, with the tiles the next
    poses need activated in both tables."""
    js = _carried_jax_state()
    log = _log()
    n = 6
    jtable = jtiles.TileTable.__new__(jtiles.TileTable)
    jtable.cfg, jtable.slot_of = JTCFG, {}
    coords = js.grid.coords
    for k in _active(coords):
        jtable.slot_of[(int(coords[k, 0]), int(coords[k, 1]))] = int(k)
    ts, ttable = tft.tiled_state_from_numpy(js, TTCFG, CPU)
    assert ttable.slot_of == jtable.slot_of
    need = jtiles.required_tiles(log["gt_poses"][CARRY_SCANS:][:n, :2],
                                 14.0, JTCFG)
    jgrid = jtable.activate(jtiles.TiledGrid(*map(jax.numpy.asarray,
                                                  js.grid)), need)
    jstate = jft.TiledFrontendState(
        jgrid, jtiles.TiledGrid(js.sgrid.tiles, jgrid.coords),
        *js[2:])
    tgrid = ttable.activate(ts.grid, need)
    ts = ts._replace(grid=tgrid, sgrid=ts.sgrid._replace(coords=tgrid.coords))
    step = jax.jit(functools.partial(jft.tiled_frontend_step, cfg=CFG,
                                     tcfg=JTCFG))
    tcfg = to_port(CFG)
    tft.tiled_frontend_step.matches = tft.tiled_frontend_step.updates = 0
    for i in range(CARRY_SCANS, CARRY_SCANS + n):
        o, r = log["odom"][i], log["ranges"][i]
        jstate, (jp, jsc) = step(jstate, jax.numpy.asarray(o),
                                 jax.numpy.asarray(r))
        ts, (tp, tsc) = tft.tiled_frontend_step(
            ts, torch.from_numpy(o), torch.from_numpy(r), tcfg, TTCFG)
        dxy, dth = pose_error(tp.numpy(), np.asarray(jp))
        assert dxy <= POSE_TOL and dth <= POSE_TOL, (i, dxy, dth)
        assert abs(float(tsc) - float(jsc)) <= 1e-4
    # the steps matched and integrated
    assert tft.tiled_frontend_step.matches > 0
    assert tft.tiled_frontend_step.updates > 0
    _assert_pools_close(ts, jax.tree.map(np.array, jstate))


def test_carried_state_keeps_its_tiles():
    """The port rebuilds the table of a carried state from its coords, so a
    run split at a chunk boundary equals one run; the JAX package starts a
    fresh table there and relabels the slots from 0 (ROADMAP queue 3,
    the reference's own quirks)."""
    log = _log()
    cfg = to_port(CFG)
    head = {k: v[:CARRY_SCANS] for k, v in log.items()}
    tail = {k: v[CARRY_SCANS:] for k, v in log.items()}
    s1, t1, sc1 = tft.run_tiled_frontend(head, cfg, TTCFG, CPU)
    kept = tft.tiled_state_to_numpy(s1)
    s2, t2, sc2 = tft.run_tiled_frontend(tail, cfg, TTCFG, CPU, state=s1)
    ts, tt, tsc, _ = _port_run()
    np.testing.assert_array_equal(np.concatenate([t1, t2]), tt)
    np.testing.assert_array_equal(np.concatenate([sc1, sc2]), tsc)
    for x, y in zip(jax.tree.leaves(tft.tiled_state_to_numpy(s2)),
                    jax.tree.leaves(tft.tiled_state_to_numpy(ts))):
        np.testing.assert_array_equal(x, y)
    # every tile of the carried state kept its slot
    act = _active(kept.grid.coords)
    np.testing.assert_array_equal(s2.grid.coords[act].numpy(),
                                  kept.grid.coords[act])
    # the reference's run starts a fresh TileTable on the carried state
    # (slam2d_tpu/run/frontend_tiled.py:192): the first tile it needs takes
    # slot 0, whatever slot 0 held, and two slots then claim that tile
    k = int(act[-1])
    rc = tuple(int(v) for v in kept.grid.coords[k])
    jgrid = jtiles.TileTable(JTCFG).activate(
        jtiles.TiledGrid(*map(jax.numpy.asarray, kept.grid)), [rc])
    assert tuple(np.asarray(jgrid.coords)[0]) == rc != tuple(
        kept.grid.coords[0])
    # the port's table, rebuilt from the coords, leaves them as they were
    table = ttiles.TileTable.from_coords(TTCFG, kept.grid.coords)
    tgrid = table.activate(tft.tiled_state_from_numpy(kept, TTCFG, CPU)[0]
                           .grid, [rc])
    np.testing.assert_array_equal(tgrid.coords.numpy(), kept.grid.coords)


@pytest.mark.parametrize("tail", [1, 17])
def test_padded_tail_runs_and_is_cut(tail):
    """A log whose length is no multiple of the chunk: the padded scans run
    (as in the JAX package) and the outputs are cut to the log."""
    log = {k: v[: CFG.chunk + tail] for k, v in _log().items()}
    tft.tiled_frontend_step.host_syncs = 0
    _, traj, scores = tft.run_tiled_frontend(log, to_port(CFG), TTCFG, CPU)
    assert traj.shape == (CFG.chunk + tail, 3) and scores.shape == traj[:, 0].shape
    n_chunks = -(-len(traj) // CFG.chunk)
    assert tft.tiled_frontend_step.host_syncs == n_chunks
    _, jtraj, _ = jft.run_tiled_frontend(log, CFG, JTCFG)
    dxy, dth = pose_error(traj, jtraj)
    assert dxy <= POSE_TOL and dth <= POSE_TOL


# the device-gated step's bits: a narrow sensor over 64^2 tiles (a 128^2
# window over three tiles a side), the log's first GATE_SCANS scans
GATE_SENSOR = SensorConfig(n_beams=60, max_range=4.0)
GATE_TCFG = ttiles.TileConfig(tile=64, n_slots=60, resolution=0.1)
GATE_SCANS = 40


@functools.cache
def _gate_log():
    world = SynthWorld.box_rooms(20.0)
    wp = np.array([[3.0, 3.0], [3.0, 8.0], [8.0, 8.0]])
    log = simulate_log(world, wp, GATE_SENSOR, step=0.15, odom_noise_xy=0.01,
                       odom_noise_theta=0.004, seed=7)
    return {k: v[:GATE_SCANS] for k, v in log.items()}


def _gated_steps(cfg, host_branch):
    """The steps one by one with `host_branch`, every tile the ground
    truth's path needs activated first: (outputs [T, 4], state, counts)."""
    log = _gate_log()
    state = tft.tiled_frontend_init(GATE_TCFG, CPU, start_pose=log["odom"][0],
                                    start_odom=log["odom"][0])
    reach = cfg.sensor.max_range + 2.0
    ttiles.TileTable(GATE_TCFG).activate(state.grid, ttiles.required_tiles(
        log["gt_poses"][:, :2], reach, GATE_TCFG))
    tft.tiled_frontend_step.matches = tft.tiled_frontend_step.updates = 0
    out = []
    for o, r in zip(log["odom"], log["ranges"]):
        state, (pose, score) = tft.tiled_frontend_step(
            state, torch.from_numpy(o), torch.from_numpy(r), cfg, GATE_TCFG,
            host_branch=host_branch)
        out.append(torch.cat([pose, score.reshape(1)]))
    counts = (tft.tiled_frontend_step.matches,
              tft.tiled_frontend_step.updates)
    return torch.stack(out), state, counts


@pytest.mark.parametrize("impl", ["pallas_hybrid", "pallas_ray", "sparse"])
def test_device_gated_step_gives_the_host_branching_bits(impl):
    """The tiled step with its gates on the device (host_branch=False: the
    windows gathered and scattered at device origins every scan, the
    kernels' plain versions and the scatters gated) gives the bits of the
    host-branching step, which skips the gated-off work: poses, scores,
    both pools and the counters."""
    cfg = FrontendConfig(
        sensor=GATE_SENSOR,
        grid=GridConfig(resolution=0.1, ray_samples=40, update_impl=impl),
        matcher=MatcherConfig(search_xy=0.25, search_theta=0.12, n_theta=9),
        chunk=16, bootstrap_dist=1.0,
    )
    t_host, s_host, n_host = _gated_steps(to_port(cfg), True)
    t_dev, s_dev, n_dev = _gated_steps(to_port(cfg), False)
    assert torch.equal(t_host, t_dev)
    for a, b in zip(tft.tiled_state_to_numpy(s_host),
                    tft.tiled_state_to_numpy(s_dev)):
        for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
            np.testing.assert_array_equal(x[:-1] if x.ndim == 3 else x,
                                          y[:-1] if y.ndim == 3 else y)
    assert n_host == n_dev
    matched = int((t_host[:, 3] != -1.0).sum())
    assert n_host[0] == matched and 0 < matched < GATE_SCANS
    assert 0 < n_host[1] < GATE_SCANS


def test_chunk_graph_needs_a_cuda_device():
    cfg = to_port(CFG)
    log = {k: v[:4] for k, v in _log().items()}
    with pytest.raises(ValueError):
        tft.run_tiled_frontend(log, cfg, TTCFG, CPU, graph=True)
    with pytest.raises(ValueError):
        tft.TiledChunkGraph(cfg, TTCFG, CPU, 4)
    # the CPU runs the eager loop, with the host-branching step
    _, traj, _ = tft.run_tiled_frontend(log, cfg, TTCFG, CPU)
    _, traj_eager, _ = tft.run_tiled_frontend(log, cfg, TTCFG, CPU,
                                              graph=False)
    np.testing.assert_array_equal(traj, traj_eager)
