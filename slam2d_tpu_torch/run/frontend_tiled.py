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
border). The gates are read on the host as in run/frontend.py, each read
bringing the window center with it. Plain integers on
`tiled_frontend_step` count the host reads (`host_syncs`: two a scan, and
the forecast's pose read once a chunk by `run_tiled_frontend`) and the
scans matched (`matches`) and integrated (`updates`); a caller may reset
them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from slam2d_tpu_torch.config import FrontendConfig, GridConfig, MatcherConfig, SensorConfig
from slam2d_tpu_torch.core import se2
from slam2d_tpu_torch.grid.occupancy import integrate_scan, window_origin_xy
from slam2d_tpu_torch.grid.tiles import (
    TileConfig,
    TiledGrid,
    TileTable,
    gather_region,
    required_tiles,
    scatter_region,
    tiled_init,
    world_to_cell_global,
)
from slam2d_tpu_torch.grid.window import blur_halo_cells
from slam2d_tpu_torch.match.correlative import build_search_space, match_scan
from slam2d_tpu_torch.run.frontend import read_gate


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
    """Fresh state on `device`: two empty tile pools."""
    f32 = dict(dtype=torch.float32, device=device)
    pose = (
        torch.zeros(3, **f32) if start_pose is None
        else torch.as_tensor(np.asarray(start_pose, np.float32), device=device)
    )
    odom = (
        pose.clone() if start_odom is None
        else torch.as_tensor(np.asarray(start_odom, np.float32), device=device)
    )
    return TiledFrontendState(
        tiled_init(tcfg, device), tiled_init(tcfg, device), pose,
        odom.clone(), torch.zeros((), **f32), pose.clone(),
        torch.zeros(2, **f32),
    )


def _param_grid_cfg(cfg: FrontendConfig, tcfg: TileConfig) -> GridConfig:
    """GridConfig carrying only the parameters the kernels read (resolution,
    log-odds constants, ray sampling); shape/origin come from the window."""
    return dataclasses.replace(cfg.grid, resolution=tcfg.resolution)


def tiled_frontend_step(
    state: TiledFrontendState, odom, ranges, cfg: FrontendConfig,
    tcfg: TileConfig, table: TileTable, plain: bool = False,
):
    """One scan of the tiled frontend; returns (state, (pose [3], score)).

    `odom` [3] and `ranges` [B] are float32 tensors on the state's device;
    `table` is the pools' host TileTable, which gives the slot of every
    tile a window overlaps. The tiles of `state` are updated in place when
    the scan is integrated. `plain=True` runs every kernel's plain version
    (for checks). The window origin is rounded from the TILE config's
    origin (`window_origin_xy` on `tcfg`)."""
    win = tiled_window_cells(tcfg, cfg.sensor, cfg.matcher)
    halo = blur_halo_cells(cfg.matcher, tcfg.resolution)
    gparam = _param_grid_cfg(cfg, tcfg)

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
    step = tiled_frontend_step
    match, center = read_gate(
        do_match, world_to_cell_global(prior[:2], tcfg), owner=step
    )
    step.matches += match
    if match:
        orc = (center[0] - win // 2, center[1] - win // 2)
        Sw = gather_region(state.sgrid, tcfg, orc, win, table)
        pose, score = match_scan(
            None, ranges, prior, gparam, cfg.matcher, cfg.sensor,
            search_space=Sw, origin_xy=window_origin_xy(tcfg, orc),
            plain=plain,
        )
        since_m = torch.zeros_like(since_m)
    else:
        pose = prior
        score = torch.full((), -1.0, dtype=torch.float32, device=odom.device)

    moved = torch.hypot(
        pose[0] - state.last_map_pose[0], pose[1] - state.last_map_pose[1]
    )
    rotated = torch.abs(se2.wrap_angle(pose[2] - state.last_map_pose[2]))
    do_update = in_boot | (moved >= cfg.map_update_min_motion) | (
        rotated >= cfg.map_update_min_rot
    )
    update, center = read_gate(
        do_update, world_to_cell_global(pose[:2], tcfg), owner=step
    )
    step.updates += update
    last_map_pose = state.last_map_pose
    if update:
        last_map_pose = pose
        orc = (center[0] - win // 2, center[1] - win // 2)
        gw = gather_region(state.grid, tcfg, orc, win, table)
        gw = integrate_scan(
            gw, pose, ranges, gparam, cfg.sensor,
            origin_xy=window_origin_xy(tcfg, orc), plain=plain,
        )
        scatter_region(state.grid, tcfg, gw, orc, table)
        # the window's outer blur-halo ring saw a truncated neighbourhood
        Sw = build_search_space(gw, cfg.matcher, tcfg.resolution, plain=plain)
        scatter_region(state.sgrid, tcfg, Sw[halo:-halo, halo:-halo],
                       (orc[0] + halo, orc[1] + halo), table)
    return (
        TiledFrontendState(
            state.grid, state.sgrid, pose, odom, state.dist + step_len,
            last_map_pose, since_m,
        ),
        (pose, score),
    )


tiled_frontend_step.host_syncs = 0
tiled_frontend_step.matches = 0
tiled_frontend_step.updates = 0


def run_tiled_frontend(
    log: dict, cfg: FrontendConfig, tcfg: TileConfig, device="cuda",
    state: TiledFrontendState | None = None, drift_margin: float = 2.0,
    plain: bool = False,
):
    """Host loop: activate tiles ahead of the odometry forecast, run chunks.

    Each chunk of cfg.chunk scans: the carried pose composed with the
    chunk's odometry deltas forecasts where the robot goes; every tile
    within max_range + search_xy + the blur halo + `drift_margin` of a
    forecast point is activated; the chunk is copied to the device and
    run; the pose is read back for the next forecast (one host read a
    chunk). The tail chunk is padded by repeating the last record (the
    padded scans run) and the outputs are truncated. A carried `state`
    keeps its tiles: the table is rebuilt from its coords (one read; the
    JAX package starts a fresh table there and relabels its slots).
    `plain=True` runs every kernel's plain version (checks only).

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
        need = required_tiles(np.asarray(fx), reach, tcfg)
        grid = table.activate(state.grid, need)
        state = state._replace(
            grid=grid, sgrid=state.sgrid._replace(coords=grid.coords)
        )

        o_t = torch.as_tensor(o, device=device)
        r_t = torch.as_tensor(r, device=device)
        for k in range(K):
            state, (pose, score) = tiled_frontend_step(
                state, o_t[k], r_t[k], cfg, tcfg, table, plain=plain
            )
            out[s + k, :3] = pose
            out[s + k, 3] = score
        tiled_frontend_step.host_syncs += 1
        est = state.pose.cpu().numpy()
        base = o[-1]
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
