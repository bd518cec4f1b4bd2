"""Frontend on the tiled, unbounded world map, port of
slam2d_tpu/run/frontend_tiled.py.

The per-scan step of run/frontend.py (gated correlative match, gated map
update, cached search space), backed by the tile pools of grid/tiles.py:
the match and the update run on one static [win, win] window, gathered
from and scattered to the tiles it overlaps, while the host activates
tiles ahead of the robot from an odometry forecast. The trajectory is
unbounded by any grid extent; capacity is the tile-pool size.

It differs from the fixed-grid step in three places: one window size for
the match and the update (`tiled_window_cells`); no clamping (the window
origin is the center cell minus win // 2); the rebuilt search-space window
always trimmed by the blur halo before it is written back (there is no
border).

The gates, the window origins and the tile slots stay on the device, as
the JAX package's `lax.cond`s and `lookup_slot` keep them: the windows
are gathered and scattered at device origins from the device coords
(grid/tiles.py:gather_region_t, scatter_region_t); the update's window
form (grid/occupancy.py:integrate_scan_window with `cell`) and kernel 3
read the gate from device memory and return at once on 0, the scatters
send a gated-off window to the trash slot, and `torch.where` selects the
match. On CUDA a whole chunk is one CUDA graph (`TiledChunkGraph`),
replayed once a chunk; the host reads the chunk's last pose for the next
forecast (one read a chunk, as the JAX package's `device_get`). On the
CPU the step branches on the gate's value instead, with the same bits
(tests/test_torch_frontend_tiled.py).

`tiled_frontend_step` counts the host reads of the runner
(`host_syncs`, a plain integer: the forecast's pose, once a chunk) and,
on the device, the scans matched (`matches`) and integrated (`updates`),
read back when the attribute is read, as run/frontend.py's
`frontend_step`; a caller may set them (to 0).
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from slam2d_tpu_torch.config import FrontendConfig, GridConfig, MatcherConfig, SensorConfig
from slam2d_tpu_torch.core import se2
from slam2d_tpu_torch.grid.occupancy import integrate_scan_window
from slam2d_tpu_torch.grid.tiles import (
    TileConfig,
    TiledGrid,
    TileTable,
    gather_region_t,
    required_tiles,
    scatter_region_t,
    tiled_init,
    world_to_cell_global,
)
from slam2d_tpu_torch.grid.window import blur_halo_cells, window_origin_xy_t
from slam2d_tpu_torch.match.correlative import gaussian_kernel_1d, match_scan
from slam2d_tpu_torch.ops.search_space import search_space_window
from slam2d_tpu_torch.run.capture import (
    ChunkCapture,
    chunk_graph_of,
    cuda_device,
    pinned,
    use_graph,
)
from slam2d_tpu_torch.run.frontend import FRONTEND_KERNELS, FrontendStep


def tiled_window_cells(tcfg: TileConfig, sensor: SensorConfig, mcfg: MatcherConfig) -> int:
    half = (
        int(math.ceil(sensor.max_range / tcfg.resolution))
        + int(round(mcfg.search_xy / tcfg.resolution))
        + blur_halo_cells(mcfg, tcfg.resolution)
        + 8
    )
    mult = 8 * mcfg.coarse_factor
    return ((2 * half + mult - 1) // mult) * mult


class TiledFrontendState(NamedTuple):
    grid: TiledGrid             # log-odds tiles
    sgrid: TiledGrid            # cached search-space tiles (same coords)
    pose: torch.Tensor          # [3]
    prev_odom: torch.Tensor     # [3]
    dist: torch.Tensor          # scalar
    last_map_pose: torch.Tensor  # [3]
    since_match: torch.Tensor   # [2]


def tiled_frontend_init(tcfg: TileConfig, device="cuda", start_pose=None,
                        start_odom=None) -> TiledFrontendState:
    """Fresh state on `device`: two empty tile pools sharing one coords
    tensor (activation writes it in place)."""
    f32 = dict(dtype=torch.float32, device=device)
    pose = (
        torch.zeros(3, **f32) if start_pose is None
        else torch.as_tensor(np.asarray(start_pose, np.float32), device=device)
    )
    odom = (
        pose.clone() if start_odom is None
        else torch.as_tensor(np.asarray(start_odom, np.float32), device=device)
    )
    grid = tiled_init(tcfg, device)
    return TiledFrontendState(
        grid, TiledGrid(torch.zeros_like(grid.tiles), grid.coords), pose,
        odom.clone(), torch.zeros((), **f32), pose.clone(),
        torch.zeros(2, **f32),
    )


def _param_grid_cfg(cfg: FrontendConfig, tcfg: TileConfig) -> GridConfig:
    """GridConfig carrying only the parameters the kernels read (resolution,
    log-odds constants, ray sampling); shape/origin come from the window."""
    return dataclasses.replace(cfg.grid, resolution=tcfg.resolution)


def _step(state: TiledFrontendState, odom, ranges, cfg: FrontendConfig,
          tcfg: TileConfig, plain: bool = False, host_branch=None,
          counts=None):
    """One scan of the tiled frontend; returns (state, (pose [3], score)).

    `odom` [3] and `ranges` [B] are float32 tensors on the state's device;
    the tiles of the scan's windows must be active in the state's coords.
    The tiles of `state` are updated in place. `plain=True` runs every
    kernel's plain version (for checks). The window origins are the
    global cells of the prior and of the pose minus win // 2, their float
    origins rounded from the TILE config's origin. The gates stay on the
    device (see the module doc); `host_branch` (default: on the CPU)
    reads each gate and skips the gated-off work, with the same bits.
    `counts` (an int64 [2] device tensor; default: the step's own
    accumulator for the device) gets the (match, update) gates added."""
    win = tiled_window_cells(tcfg, cfg.sensor, cfg.matcher)
    mcfg = cfg.matcher
    halo = blur_halo_cells(mcfg, tcfg.resolution)
    gparam = _param_grid_cfg(cfg, tcfg)
    lattice = (tcfg.origin_x, tcfg.origin_y)
    dev = odom.device
    if host_branch is None:
        host_branch = dev.type == "cpu"

    delta = se2.between(state.prev_odom, odom)
    step_len = torch.hypot(delta[0], delta[1])
    prior = se2.compose(state.pose, delta)
    in_boot = state.dist < cfg.bootstrap_dist
    since_m = state.since_match + torch.stack(
        [step_len, torch.abs(se2.wrap_angle(delta[2]))]
    )
    do_match = (~in_boot) & (
        (since_m[0] >= cfg.match_min_motion) | (since_m[1] >= cfg.match_min_rot)
    )
    if not host_branch or bool(do_match):
        orc = world_to_cell_global(prior[:2], tcfg) - win // 2
        Sw = gather_region_t(state.sgrid, tcfg, orc, win)
        pose, score = match_scan(
            None, ranges, prior, gparam, mcfg, cfg.sensor, search_space=Sw,
            origin_xy=window_origin_xy_t(*lattice, tcfg.resolution, orc),
            plain=plain, gate=do_match,
        )
        pose = torch.where(do_match, pose, prior)
        score = torch.where(do_match, score, -1.0)
        since_m = torch.where(do_match, 0.0, since_m)
    else:
        pose, score = prior, torch.full_like(prior[0], -1.0)

    moved = torch.hypot(
        pose[0] - state.last_map_pose[0], pose[1] - state.last_map_pose[1]
    )
    rotated = torch.abs(se2.wrap_angle(pose[2] - state.last_map_pose[2]))
    do_update = in_boot | (moved >= cfg.map_update_min_motion) | (
        rotated >= cfg.map_update_min_rot
    )
    if counts is None:
        counts = tiled_frontend_step.counter(dev)
    counts += torch.stack([do_match, do_update])
    if not host_branch or bool(do_update):
        orc = world_to_cell_global(pose[:2], tcfg) - win // 2
        gw = gather_region_t(state.grid, tcfg, orc, win)
        integrate_scan_window(gw, pose, ranges, gparam, cfg.sensor,
                              origin=None, cell=orc, size=(win, win),
                              gate=do_update, origin_xy=lattice, plain=plain)
        scatter_region_t(state.grid, tcfg, gw, orc, gate=do_update)
        # the window's outer blur-halo ring saw a truncated neighbourhood
        Sw = torch.empty_like(gw)
        search_space_window(
            gw, Sw, gaussian_kernel_1d(mcfg.sigma_m / tcfg.resolution, halo),
            origin=None, size=(win, win), margin=halo, gate=do_update,
            occ_sat=mcfg.occ_evidence_sat, free_threshold=mcfg.free_threshold,
            free_penalty=mcfg.free_penalty, plain=plain,
        )
        scatter_region_t(state.sgrid, tcfg, Sw[halo:-halo, halo:-halo],
                         orc + halo, gate=do_update)
    last_map_pose = torch.where(do_update, pose, state.last_map_pose)
    return (
        TiledFrontendState(
            state.grid, state.sgrid, pose, odom, state.dist + step_len,
            last_map_pose, since_m,
        ),
        (pose, score),
    )


class _TiledFrontendStep(FrontendStep):
    """`tiled_frontend_step`: one scan, with its counters (module doc)."""

    def __call__(self, state, odom, ranges, cfg, tcfg, plain=False,
                 host_branch=None, counts=None):
        return _step(state, odom, ranges, cfg, tcfg, plain, host_branch,
                     counts)


tiled_frontend_step = _TiledFrontendStep()
tiled_frontend_step.__doc__ = _step.__doc__


class TiledChunkGraph(ChunkCapture):
    """K tiled frontend steps of one config on one CUDA device, captured
    as one CUDA graph on static buffers: the state (both tile pools with
    one coords buffer, and the five pose fields), odometry [K, 3], ranges
    [K, B], the outputs [K, 4] (pose, score) and the (matches, updates)
    counters. Built once per (cfg, tcfg, device, K) (`tiled_chunk_graph`)
    by run/capture.py's ChunkCapture: `load` copies a state in (the
    buffers a caller already holds are skipped), `run_chunk` replays,
    `finish` clones the state out; `state` holds the live buffers between
    them, and the host activates tiles into `state.grid.coords` in place.
    The warm-up steps run with every slot free: their windows read zeros
    and write to the trash slot. The kernels' launch counters count a
    capture's launches once a replay. A failed build or capture raises;
    nothing falls back to the eager loop."""

    step = tiled_frontend_step

    def __init__(self, cfg: FrontendConfig, tcfg: TileConfig, device,
                 K: int):
        device = cuda_device(device)
        self.cfg, self.tcfg, self.device, self.K = cfg, tcfg, device, K
        f32 = dict(dtype=torch.float32, device=device)
        self.state = tiled_frontend_init(tcfg, device)
        self.inputs = (torch.zeros((K, 3), **f32),
                       torch.zeros((K, cfg.sensor.n_beams), **f32))
        self.out = torch.zeros((K, 4), **f32)
        self.counts = torch.zeros(2, dtype=torch.int64, device=device)
        self._capture(FRONTEND_KERNELS)

    def _one(self, k, state):
        """Step k of the chunk from `state`, its outputs into out[k]."""
        odom, ranges = self.inputs
        state, (pose, score) = _step(
            state, odom[k], ranges[k], self.cfg, self.tcfg,
            host_branch=False, counts=self.counts,
        )
        self.out[k, :3] = pose
        self.out[k, 3] = score
        return state

    def _buffers(self, state):
        """The tiles of both pools, the coords (the log-odds pool's), the
        pose fields."""
        return (state.grid.tiles, state.sgrid.tiles, state.grid.coords,
                *state[2:])

    def _clone(self, state):
        """Both pools share the clone of the coords."""
        coords = state.grid.coords.clone()
        return TiledFrontendState(
            TiledGrid(state.grid.tiles.clone(), coords),
            TiledGrid(state.sgrid.tiles.clone(), coords),
            *(t.clone() for t in state[2:]),
        )


def tiled_chunk_graph(cfg: FrontendConfig, tcfg: TileConfig, device,
                      K: int) -> TiledChunkGraph:
    """The cached TiledChunkGraph of (cfg, tcfg, device, K), built on first
    use."""
    return chunk_graph_of(TiledChunkGraph, cfg, tcfg, torch.device(device), K)


def _shared_coords(state: TiledFrontendState) -> TiledFrontendState:
    """`state` with the search-space pool on the log-odds pool's coords
    tensor, which activation writes in place."""
    if state.sgrid.coords is state.grid.coords:
        return state
    return state._replace(sgrid=state.sgrid._replace(coords=state.grid.coords))


def run_tiled_chunk(state: TiledFrontendState, odom, ranges,
                    cfg: FrontendConfig, tcfg: TileConfig, out,
                    plain: bool = False, graph: bool | None = None
                    ) -> TiledFrontendState:
    """One chunk of the tiled frontend, the port's counterpart of the JAX
    package's `make_tiled_chunk_fn`: `odom` [K, 3] and `ranges` [K, B]
    (numpy arrays) stepped in order, each scan's pose and score written
    into row k of `out` [K, 4] (a tensor on the device). The tiles the
    chunk needs must be active in the state's coords. On CUDA (unless
    `plain` or `graph=False`) one replay of the config's TiledChunkGraph:
    the state copied into its buffers and the new state cloned out of
    them, nothing read back. Else the steps one by one, the state's tiles
    written in place. Returns the state after the chunk."""
    device = out.device
    if use_graph(device, plain, graph):
        g = tiled_chunk_graph(cfg, tcfg, device, len(odom))
        g.load(state)
        g.run_chunk(pinned(odom), pinned(ranges), out)
        return g.finish()
    state = _shared_coords(state)
    o_t = torch.as_tensor(np.asarray(odom, np.float32), device=device)
    r_t = torch.as_tensor(np.asarray(ranges, np.float32), device=device)
    for k in range(o_t.shape[0]):
        state, (pose, score) = tiled_frontend_step(
            state, o_t[k], r_t[k], cfg, tcfg, plain=plain
        )
        out[k, :3] = pose
        out[k, 3] = score
    return state


def run_tiled_frontend(
    log: dict, cfg: FrontendConfig, tcfg: TileConfig, device="cuda",
    state: TiledFrontendState | None = None, drift_margin: float = 2.0,
    plain: bool = False, graph: bool | None = None,
):
    """Host loop: activate tiles ahead of the odometry forecast, run chunks.

    Each chunk of cfg.chunk scans: the carried pose composed with the
    chunk's odometry deltas forecasts where the robot goes; every tile
    within max_range + search_xy + the blur halo + `drift_margin` of a
    forecast point is activated (written into the coords in place); the
    chunk runs; the pose is read back for the next forecast (one host read
    a chunk). On CUDA (unless `plain`, which runs every kernel's plain
    version for checks, or `graph=False`) the state is loaded into the
    config's TiledChunkGraph once, each chunk is one replay, and the final
    state is cloned out of it: the caller's state is left as it was. Else
    the steps run eagerly, the state's tiles written in place. The tail
    chunk is padded by repeating the last record (the padded scans run)
    and the outputs are truncated. A carried `state` keeps its tiles: the
    table is rebuilt from its coords (one read; the JAX package starts a
    fresh table there and relabels its slots).

    Returns (final_state, traj [T, 3] np.ndarray, scores [T] np.ndarray).
    """
    odom = np.asarray(log["odom"], np.float32)
    ranges = np.asarray(log["ranges"], np.float32)
    T = len(odom)
    K = cfg.chunk
    if state is None:
        state = tiled_frontend_init(tcfg, device, start_pose=odom[0],
                                    start_odom=odom[0])
        table = TileTable(tcfg)
        est, base = odom[0], odom[0]
    else:
        tiled_frontend_step.host_syncs += 1
        packed = torch.cat([
            state.grid.coords.reshape(-1).to(torch.float64),
            torch.cat([state.pose, state.prev_odom]).to(torch.float64),
        ]).cpu().numpy()
        n = state.grid.coords.numel()
        table = TileTable.from_coords(
            tcfg, packed[:n].astype(np.int32).reshape(-1, 2))
        est = packed[n : n + 3].astype(np.float32)
        base = packed[n + 3 :].astype(np.float32)
    reach = (
        cfg.sensor.max_range + cfg.matcher.search_xy
        + blur_halo_cells(cfg.matcher, tcfg.resolution) * tcfg.resolution
        + drift_margin
    )
    n_run = -(-T // K) * K
    out = torch.empty((n_run, 4), dtype=torch.float32, device=device)
    g = None
    if use_graph(device, plain, graph):
        g = tiled_chunk_graph(cfg, tcfg, device, K)
        g.load(state)
        state = g.state
    else:
        state = _shared_coords(state)
    for s in range(0, T, K):
        o = odom[s : s + K]
        r = ranges[s : s + K]
        if len(o) < K:
            pad = K - len(o)
            o = np.concatenate([o, np.repeat(o[-1:], pad, axis=0)])
            r = np.concatenate([r, np.repeat(r[-1:], pad, axis=0)])

        # forecast: current estimate composed with the chunk's odom deltas
        fx = []
        for t in range(len(o)):
            d = _np_between(base, o[t])
            fx.append(_np_compose(est, d)[:2])
        table.activate(state.grid, required_tiles(np.asarray(fx), reach,
                                                  tcfg))
        if g is None:
            state = run_tiled_chunk(state, o, r, cfg, tcfg, out[s : s + K],
                                    plain, graph=False)
        else:
            g.run_chunk(pinned(o), pinned(r), out[s : s + K])
        tiled_frontend_step.host_syncs += 1
        est = state.pose.cpu().numpy()
        base = o[-1]
    if g is not None:
        state = g.finish()
    out = out[:T].cpu().numpy()
    return state, out[:, :3].copy(), out[:, 3].copy()


def tiled_state_from_numpy(arrays, tcfg: TileConfig, device):
    """(TiledFrontendState on `device`, its host TileTable) from the
    state's fields as numpy arrays in field order, each grid a pair
    (tiles, coords): e.g. `jax.tree.map(np.asarray, jax_state)` of a JAX
    TiledFrontendState, whose fields are the same. The table is rebuilt
    from the coords."""
    grid, sgrid, *rest = arrays

    def pool(g):
        tiles, coords = g
        return TiledGrid(
            torch.as_tensor(np.array(tiles, np.float32), device=device),
            torch.as_tensor(np.array(coords, np.int32), device=device),
        )

    state = TiledFrontendState(
        pool(grid), pool(sgrid),
        *(torch.as_tensor(np.array(a, np.float32), device=device)
          for a in rest),
    )
    return state, TileTable.from_coords(tcfg, np.asarray(grid[1]))


def tiled_state_to_numpy(state: TiledFrontendState) -> TiledFrontendState:
    """The state's fields as numpy arrays (a TiledFrontendState whose grids
    are TiledGrids of numpy arrays)."""
    grid, sgrid, *rest = state
    return TiledFrontendState(
        TiledGrid(*(t.cpu().numpy() for t in grid)),
        TiledGrid(*(t.cpu().numpy() for t in sgrid)),
        *(t.cpu().numpy() for t in rest),
    )


def _np_between(a, b):
    c, s = np.cos(a[2]), np.sin(a[2])
    dx, dy = b[0] - a[0], b[1] - a[1]
    return np.array(
        [c * dx + s * dy, -s * dx + c * dy,
         (b[2] - a[2] + np.pi) % (2 * np.pi) - np.pi]
    )


def _np_between_batch(a, B):
    """_np_between(a, b) for every row b of B [N, 3] -> [N, 3]."""
    c, s = np.cos(a[2]), np.sin(a[2])
    dx, dy = B[:, 0] - a[0], B[:, 1] - a[1]
    return np.stack(
        [c * dx + s * dy, -s * dx + c * dy,
         (B[:, 2] - a[2] + np.pi) % (2 * np.pi) - np.pi],
        axis=1,
    ).astype(np.float32)


def _np_compose(a, d):
    c, s = np.cos(a[2]), np.sin(a[2])
    return np.array(
        [a[0] + c * d[0] - s * d[1], a[1] + s * d[0] + c * d[1],
         (a[2] + d[2] + np.pi) % (2 * np.pi) - np.pi]
    )


def _np_compose_batch(a, D):
    """_np_compose(a, d) for every row d of D [N, 3] -> [N, 3]."""
    c, s = np.cos(a[2]), np.sin(a[2])
    return np.stack(
        [a[0] + c * D[:, 0] - s * D[:, 1],
         a[1] + s * D[:, 0] + c * D[:, 1],
         (a[2] + D[:, 2] + np.pi) % (2 * np.pi) - np.pi],
        axis=1,
    ).astype(np.float32)


def _np_inverse(a):
    """SE(2) inverse: _np_compose(a, _np_inverse(a)) == identity."""
    c, s = np.cos(a[2]), np.sin(a[2])
    return np.array([-(c * a[0] + s * a[1]), s * a[0] - c * a[1], -a[2]])
