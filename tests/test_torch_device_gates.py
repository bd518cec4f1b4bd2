"""PyTorch port: the frontend step's device-side gates (CPU).

The step keeps its motion gates and window origins on the device: kernel
1 `hybrid` updates the map in place at a device origin, kernel 3 writes
the kept rectangle of the rebuilt search space in place, kernel 2 returns
at once on a gate of 0, and the step selects with torch.where
(run/frontend.py). Here, on the CPU, through the plain versions:

- each window form with gate 0 leaves its operand bit-identical, and with
  gate 1 gives the bits of the host-origin path (extract_window -> op ->
  write_window / write_window_blur_exact) at windows clamped into each
  corner of the map, in its interior, and centered off the map;
- the device window origin and float origin equal the host ones
  (window_origin, window_origin_xy) for every origin of the bench
  config's windows;
- the device-gated step (host_branch=False) gives the bits of the
  host-branching step, which reads each gate and skips the gated-off
  work, over the frontend test log, unwindowed and windowed, and in
  localization mode.

Tolerance: none, every comparison is bit for bit.
"""

import dataclasses

import numpy as np
import pytest
import torch

from slam2d_tpu_torch.config import GridConfig, MatcherConfig, SensorConfig
from slam2d_tpu_torch.grid import occupancy as tocc
from slam2d_tpu_torch.grid import window as twin
from slam2d_tpu_torch.match.correlative import (
    build_search_space,
    gaussian_kernel_1d,
)
from slam2d_tpu_torch.ops.score import score_window
from slam2d_tpu_torch.ops.search_space import search_space_window
from slam2d_tpu_torch.run import bench_configs
from slam2d_tpu_torch.run import frontend as tfe
from torch_parity import e2e_log, frontend_cfg, to_port

torch.set_num_threads(1)

CPU = torch.device("cpu")
SIZE = 160     # the map's side, cells
WIN = 96       # the window's side: 64 cells of play each way
SENSOR = SensorConfig(n_beams=180, max_range=3.0)
GRID = GridConfig(height=SIZE, width=SIZE, resolution=0.05, center_x=1.3,
                  center_y=-0.7, update_impl="pallas_hybrid")
MATCHER = MatcherConfig()
# window centers (row, col): clamped into each corner, inside, off the map
CENTERS = {
    "top_left": (10, 7), "top_right": (5, 151), "bottom_left": (150, 12),
    "bottom_right": (157, 149), "interior": (83, 71), "off_map": (-40, 400),
}


def _pose(center, seed):
    """A pose at the center of cell `center` (clipped into the map), with
    a heading drawn from the seed."""
    rng = np.random.default_rng(seed)
    r, c = np.clip(center, 0, SIZE - 1)
    res = np.float32(GRID.resolution)
    x = np.float32(GRID.origin_x) + (np.float32(c) + np.float32(0.5)) * res
    y = np.float32(GRID.origin_y) + (np.float32(r) + np.float32(0.5)) * res
    return torch.tensor([x, y, rng.uniform(-np.pi, np.pi)], dtype=torch.float32)


def _map(seed):
    rng = np.random.default_rng(seed)
    lc = GRID.l_clamp
    g = rng.uniform(-lc, lc, (SIZE, SIZE)).astype(np.float32)
    g[rng.random((SIZE, SIZE)) < 0.3] = 0.0
    return torch.from_numpy(g)


def _ranges(seed):
    """Hits, max-range beams, beams below min_range and NaN."""
    rng = np.random.default_rng(seed)
    r = rng.uniform(0.0, 3.5, SENSOR.n_beams).astype(np.float32)
    r[rng.random(SENSOR.n_beams) < 0.05] = np.nan
    return torch.from_numpy(r)


def _origin(center):
    return twin.window_origin_t(torch.tensor(center, dtype=torch.int32), WIN,
                                SIZE, SIZE)


def test_window_origin_matches_the_host_form():
    for r in range(-60, SIZE + 60, 7):
        for c in (-300, -1, 0, 33, 47, 48, 112, 113, SIZE + 5):
            o = twin.window_origin_t(torch.tensor([r, c], dtype=torch.int32),
                                     WIN, SIZE, SIZE)
            assert o.dtype == torch.int32
            assert tuple(o.tolist()) == twin.window_origin((r, c), WIN, SIZE,
                                                           SIZE)


@pytest.mark.parametrize("cfg_name", ["bench", "frontend_512", "tiny"])
def test_float_origin_matches_window_origin_xy_for_every_c0(cfg_name):
    """window_origin_xy_t against window_origin_xy for every origin of
    the config's scan and update windows (both axes)."""
    if cfg_name == "bench":
        cfg = bench_configs.bench_config()
    elif cfg_name == "frontend_512":
        cfg = to_port(frontend_cfg(512))
    else:
        cfg = tfe.FrontendConfig(grid=GRID, sensor=SENSOR, matcher=MATCHER)
    g = cfg.grid
    for win in (twin.scan_window_cells(g, cfg.sensor, cfg.matcher),
                twin.update_window_cells(g, cfg.sensor, cfg.matcher)):
        n = min(g.height, g.width) - win + 1
        c0 = torch.arange(n, dtype=torch.int32)
        origins = torch.stack([c0.flip(0), c0], dim=1)
        got = twin.window_origin_xy_t(g.origin_x, g.origin_y, g.resolution,
                                      origins).numpy()
        want = np.array([tocc.window_origin_xy(g, (int(r), int(c)))
                         for r, c in origins.tolist()], np.float32)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("where", list(CENTERS))
def test_take_put_and_keep_match_the_host_window_ops(where):
    g = _map(1)
    o = _origin(CENTERS[where])
    r0, c0 = twin.window_origin(CENTERS[where], WIN, SIZE, SIZE)
    assert tuple(o.tolist()) == (r0, c0)
    assert torch.equal(twin.take_window(g, o, (WIN, WIN)),
                       g[r0 : r0 + WIN, c0 : c0 + WIN])
    new = torch.full((WIN, WIN), 7.5)
    ref = twin.write_window(g.clone(), new, (r0, c0))
    assert torch.equal(twin.put_window(g.clone(), new, o), ref)
    margin = twin.blur_halo_cells(MATCHER, GRID.resolution)
    ref = twin.write_window_blur_exact(torch.zeros(SIZE, SIZE), new + 1.0,
                                       (r0, c0), margin)
    keep = twin.blur_exact_keep(o, (WIN, WIN), (SIZE, SIZE), margin)
    assert torch.equal(keep, ref[r0 : r0 + WIN, c0 : c0 + WIN] != 0)


def _update_args():
    return dict(cfg=GRID, sensor=SENSOR)


@pytest.mark.parametrize("where", list(CENTERS))
def test_hybrid_in_place_matches_extract_update_write(where):
    center = CENTERS[where]
    g, pose, ranges = _map(2), _pose(center, 3), _ranges(4)
    ref = g.clone()
    gw, orc = twin.extract_window(ref, tocc.world_to_cell(pose[:2], GRID),
                                  WIN)
    gw = tocc.integrate_scan(gw, pose, ranges, GRID, SENSOR, origin_rc=orc)
    twin.write_window(ref, gw, orc)
    assert not torch.equal(ref, g)
    o = twin.window_origin_t(tocc.world_to_cell(pose[:2], GRID), WIN, SIZE,
                             SIZE)
    for gate, want in ((True, ref), (False, g)):
        out = g.clone()
        back = tocc.integrate_scan_window(
            out, pose, ranges, GRID, SENSOR, origin=o, size=(WIN, WIN),
            gate=torch.tensor(gate))
        assert back is out
        assert torch.equal(out, want), gate


def test_hybrid_in_place_on_the_whole_map():
    g, pose, ranges = _map(5), _pose((80, 80), 6), _ranges(7)
    ref = tocc.integrate_scan(g, pose, ranges, GRID, SENSOR)
    for gate, want in ((True, ref), (False, g)):
        out = g.clone()
        tocc.integrate_scan_window(out, pose, ranges, GRID, SENSOR,
                                   origin=None, size=(SIZE, SIZE),
                                   gate=torch.tensor(gate))
        assert torch.equal(out, want), gate


def _taps():
    halo = twin.blur_halo_cells(MATCHER, GRID.resolution)
    return gaussian_kernel_1d(MATCHER.sigma_m / GRID.resolution, halo), halo


def _field_kw():
    return dict(occ_sat=MATCHER.occ_evidence_sat,
                free_threshold=MATCHER.free_threshold,
                free_penalty=MATCHER.free_penalty)


@pytest.mark.parametrize("where", list(CENTERS))
def test_search_space_kept_rectangle_matches_extract_build_write(where):
    l = _map(8)
    S = build_search_space(_map(9), MATCHER, GRID.resolution)
    taps, halo = _taps()
    r0, c0 = twin.window_origin(CENTERS[where], WIN, SIZE, SIZE)
    ref = S.clone()
    Sw = build_search_space(l[r0 : r0 + WIN, c0 : c0 + WIN].contiguous(),
                            MATCHER, GRID.resolution)
    twin.write_window_blur_exact(ref, Sw, (r0, c0), halo)
    for gate, want in ((True, ref), (False, S)):
        out = S.clone()
        back = search_space_window(
            l, out, taps, origin=_origin(CENTERS[where]), size=(WIN, WIN),
            margin=halo, gate=torch.tensor(gate), **_field_kw())
        assert back is out
        assert torch.equal(out, want), gate


def test_search_space_window_on_the_whole_map_and_its_checks():
    l = _map(10)
    S = torch.zeros(SIZE, SIZE)
    taps, halo = _taps()
    search_space_window(l, S, taps, origin=None, size=(SIZE, SIZE),
                        margin=0, gate=torch.tensor(True), **_field_kw())
    assert torch.equal(S, build_search_space(l, MATCHER, GRID.resolution))
    # a kept cell's blur must lie inside its window
    with pytest.raises(ValueError):
        search_space_window(l, S, taps, origin=_origin((80, 80)),
                            size=(WIN, WIN), margin=halo - 1, gate=None,
                            **_field_kw())
    with pytest.raises(ValueError):
        search_space_window(l, S, taps, origin=_origin((80, 80)).long(),
                            size=(WIN, WIN), margin=halo, gate=None,
                            **_field_kw())


@pytest.mark.parametrize("bilinear", [True, False])
def test_score_gate_keeps_out(bilinear):
    rng = np.random.default_rng(11)
    S = torch.from_numpy(rng.uniform(-0.5, 1, (64, 72)).astype(np.float32))
    pos_row = torch.from_numpy(rng.uniform(-3, 66, (5, 40)).astype(np.float32))
    pos_col = torch.from_numpy(rng.uniform(-3, 74, (5, 40)).astype(np.float32))
    valid = torch.from_numpy(rng.random(40) < 0.8)
    ref = score_window(S, pos_row, pos_col, valid, 4, bilinear)
    sentinel = torch.full((5, 9, 9), 123.0)
    out = sentinel.clone()
    got = score_window(S, pos_row, pos_col, valid, 4, bilinear,
                       gate=torch.tensor(False), out=out)
    assert got is out and torch.equal(out, sentinel)
    got = score_window(S, pos_row, pos_col, valid, 4, bilinear,
                       gate=torch.tensor(True), out=out)
    assert got is out and torch.equal(out, ref)


def _run_steps(cfg, log, host_branch, state=None):
    odom = torch.from_numpy(np.asarray(log["odom"], np.float32))
    ranges = torch.from_numpy(np.asarray(log["ranges"], np.float32))
    if state is None:
        state = tfe.frontend_init(cfg, CPU, start_pose=log["odom"][0],
                                  start_odom=log["odom"][0])
    tfe.frontend_step.matches = tfe.frontend_step.updates = 0
    out = []
    for k in range(len(odom)):
        state, (pose, score) = tfe.frontend_step(
            state, odom[k], ranges[k], cfg, host_branch=host_branch)
        out.append(torch.cat([pose, score.reshape(1)]))
    counts = (tfe.frontend_step.matches, tfe.frontend_step.updates)
    return torch.stack(out), state, counts


@pytest.mark.parametrize("size", [256, 512])
def test_device_gated_step_gives_the_host_branching_bits(size):
    """256^2 runs unwindowed, 512^2 a 288^2 scan and a 272^2 update
    window (tests/torch_parity.py)."""
    cfg = to_port(frontend_cfg(size))
    log = e2e_log()
    t_host, s_host, n_host = _run_steps(cfg, log, True)
    t_dev, s_dev, n_dev = _run_steps(cfg, log, False)
    assert torch.equal(t_host, t_dev)
    for a, b in zip(s_host, s_dev):
        assert torch.equal(a, b)
    assert n_host == n_dev
    matched = int((t_host[:, 3] != -1.0).sum())
    assert n_host[0] == matched and 0 < matched < len(t_host)
    assert 0 < n_host[1] < len(t_host)


def test_device_gated_localization_gives_the_host_branching_bits():
    cfg = to_port(frontend_cfg(512))
    log = e2e_log()
    _, mapped, _ = _run_steps(cfg, log, True)
    loc = dataclasses.replace(cfg, localize_only=True)
    runs = []
    for host_branch in (True, False):
        start = mapped._replace(logodds=mapped.logodds.clone(),
                                search_space=mapped.search_space.clone())
        runs.append(_run_steps(loc, log, host_branch, state=start))
    (t_host, s_host, n_host), (t_dev, s_dev, n_dev) = runs
    assert torch.equal(t_host, t_dev) and n_host == n_dev
    assert n_host[1] == 0 and n_host[0] > 0
    for a, b in zip(s_host, s_dev):
        assert torch.equal(a, b)
    assert torch.equal(s_dev.logodds, mapped.logodds)


def test_graph_runs_need_a_cuda_device():
    cfg = to_port(frontend_cfg(256))
    log = {k: v[:4] for k, v in e2e_log().items()}
    with pytest.raises(ValueError):
        tfe.run_frontend(log, cfg, CPU, graph=True)
    with pytest.raises(ValueError):
        tfe.ChunkGraph(cfg, CPU, 4)
    # the CPU runs the eager loop, with the host-branching step
    _, traj, _ = tfe.run_frontend(log, cfg, CPU)
    _, traj_eager, _ = tfe.run_frontend(log, cfg, CPU, graph=False)
    np.testing.assert_array_equal(traj, traj_eager)
