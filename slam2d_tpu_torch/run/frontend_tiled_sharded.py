"""The tiled frontend on a tile pool split over the ranks of a mesh, port
of slam2d_tpu/run/frontend_tiled_sharded.py.

The per-scan step of run/frontend_tiled.py (the match, the update and
the search-space rebuild on one static window: kernels 2, 1 `hybrid` and
3), its window gathered and scattered through grid/tiles_sharded.py:
each rank's memory holds n_slots / world_size tiles, so the world's
capacity grows with the ranks, and the per-scan work is replicated. The
gates are read on the host, each rank reading its own: they come from the
odometry and from the replicated match, the same bits on every rank.

The slot table is the host's (grid/tiles.py's TileTable), sized to the
padded pool (n_slots rounded up to a multiple of the world size). Tiles
are activated once a chunk ahead of the odometry forecast, from rank 0's
pose, which every rank receives; a rank whose pose differs from rank 0's
raises (ranks that diverged).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from slam2d_tpu_torch.config import FrontendConfig
from slam2d_tpu_torch.core import se2
from slam2d_tpu_torch.grid.occupancy import integrate_scan, window_origin_xy
from slam2d_tpu_torch.grid.tiles import (
    FREE_SLOT,
    TileConfig,
    TiledGrid,
    TileTable,
    required_tiles,
    world_to_cell_global,
)
from slam2d_tpu_torch.grid.tiles_sharded import (
    gather_region_sharded,
    scatter_region_sharded,
)
from slam2d_tpu_torch.grid.window import blur_halo_cells
from slam2d_tpu_torch.match.correlative import build_search_space, match_scan
from slam2d_tpu_torch.parallel import mesh as pmesh
from slam2d_tpu_torch.run.frontend_tiled import (
    _np_between,
    _np_compose,
    _param_grid_cfg,
    tiled_window_cells,
)


def read_gate(gate, center_rc, owner):
    """One device-to-host read of a gate and a window center with it,
    counted in `owner.host_syncs`."""
    owner.host_syncs += 1
    # one copy to the host: tolist() of a CUDA tensor copies per element
    packed = torch.cat([gate.reshape(1).to(torch.int32), center_rc]).cpu()
    g, r, c = packed.tolist()
    return bool(g), (r, c)


def make_tile_mesh(mesh: pmesh.Mesh | None = None) -> pmesh.Mesh:
    """The mesh the tile pool splits over: `mesh`, or the one this process
    joined (JAX's make_tile_mesh picks devices; here a world is joined
    with parallel/mesh.py first)."""
    return pmesh.current() if mesh is None else mesh


class ShardedTiledState(NamedTuple):
    tiles: torch.Tensor          # [n_local, t, t] this rank's log-odds tiles
    stiles: torch.Tensor         # [n_local, t, t] its search-space tiles
    coords: torch.Tensor         # [N_pad + 1, 2] int32 slot table (trash last)
    pose: torch.Tensor           # [3]
    prev_odom: torch.Tensor      # [3]
    dist: torch.Tensor           # 0-d
    last_map_pose: torch.Tensor  # [3]
    since_match: torch.Tensor    # [2]


def padded_slots(tcfg: TileConfig, mesh: pmesh.Mesh) -> int:
    """n_slots rounded up to a multiple of the world size."""
    d = mesh.world_size
    return -(-tcfg.n_slots // d) * d


def sharded_tiled_init(tcfg: TileConfig, mesh: pmesh.Mesh, start_pose=None,
                       start_odom=None) -> ShardedTiledState:
    """A fresh state: this rank's block of two empty pools on the mesh's
    device (equal blocks of the padded pool) and the replicated fields."""
    dev = mesh.device
    n_pad = padded_slots(tcfg, mesh)
    n_local = n_pad // mesh.world_size
    f32 = dict(dtype=torch.float32, device=dev)
    pose = (
        torch.zeros(3, **f32) if start_pose is None
        else torch.as_tensor(np.asarray(start_pose, np.float32), device=dev)
    )
    odom = (
        pose.clone() if start_odom is None
        else torch.as_tensor(np.asarray(start_odom, np.float32), device=dev)
    )
    return ShardedTiledState(
        tiles=torch.zeros((n_local, tcfg.tile, tcfg.tile), **f32),
        stiles=torch.zeros((n_local, tcfg.tile, tcfg.tile), **f32),
        coords=torch.full((n_pad + 1, 2), int(FREE_SLOT), dtype=torch.int32,
                          device=dev),
        pose=pose, prev_odom=odom.clone(), dist=torch.zeros((), **f32),
        last_map_pose=pose.clone(), since_match=torch.zeros(2, **f32),
    )


def sharded_tiled_step(state: ShardedTiledState, odom, ranges,
                       cfg: FrontendConfig, tcfg: TileConfig,
                       table: TileTable, mesh: pmesh.Mesh,
                       plain: bool = False):
    """One scan (run/frontend_tiled.py's tiled_frontend_step with the
    sharded region ops); returns (state, (pose [3], score)). The local
    tiles are written in place. Two host reads a scan (the gates,
    counted on `sharded_tiled_step.host_syncs`), one window psum a match
    and one an update (the search-space tiles are scattered, not
    gathered)."""
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
    step = sharded_tiled_step
    match, center = read_gate(
        do_match, world_to_cell_global(prior[:2], tcfg), owner=step
    )
    step.matches += match
    if match:
        orc = (center[0] - win // 2, center[1] - win // 2)
        Sw = gather_region_sharded(state.stiles, tcfg, orc, win, table, mesh)
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
        gw = gather_region_sharded(state.tiles, tcfg, orc, win, table, mesh)
        gw = integrate_scan(
            gw, pose, ranges, gparam, cfg.sensor,
            origin_xy=window_origin_xy(tcfg, orc), plain=plain,
        )
        scatter_region_sharded(state.tiles, tcfg, gw, orc, table, mesh)
        # the window's outer blur-halo ring saw a truncated neighbourhood
        Sw = build_search_space(gw, cfg.matcher, tcfg.resolution, plain=plain)
        scatter_region_sharded(state.stiles, tcfg, Sw[halo:-halo, halo:-halo],
                               (orc[0] + halo, orc[1] + halo), table, mesh)
    return (
        ShardedTiledState(
            state.tiles, state.stiles, state.coords, pose, odom,
            state.dist + step_len, last_map_pose, since_m,
        ),
        (pose, score),
    )


sharded_tiled_step.host_syncs = 0
sharded_tiled_step.matches = 0
sharded_tiled_step.updates = 0


def run_sharded_tiled_chunk(state: ShardedTiledState, table: TileTable,
                            odom, ranges, cfg: FrontendConfig,
                            tcfg: TileConfig, mesh: pmesh.Mesh, out,
                            plain: bool = False) -> ShardedTiledState:
    """One chunk (the counterpart of JAX's make_sharded_tiled_chunk_fn):
    `odom` [K, 3] and `ranges` [K, B] stepped in order, each scan's pose
    and score written into row k of `out` [K, 4] on the device."""
    device = state.pose.device
    o_t = torch.as_tensor(odom, dtype=torch.float32, device=device)
    r_t = torch.as_tensor(ranges, dtype=torch.float32, device=device)
    for k in range(o_t.shape[0]):
        state, (pose, score) = sharded_tiled_step(
            state, o_t[k], r_t[k], cfg, tcfg, table, mesh, plain=plain
        )
        out[k, :3] = pose
        out[k, 3] = score
    return state


def _agreed_pose(pose, mesh: pmesh.Mesh) -> np.ndarray:
    """Rank 0's pose on the host of every rank (one all_gather, counted
    as a host read); raises if any rank's pose differs from it."""
    sharded_tiled_step.host_syncs += 1
    poses = mesh.all_gather(pose).cpu().numpy()
    if not (poses == poses[0]).all():
        raise RuntimeError(
            f"rank {mesh.rank}: the ranks' poses diverged: {poses.tolist()}")
    return poses[0]


def run_sharded_tiled_frontend(
    log: dict, cfg: FrontendConfig, tcfg: TileConfig,
    mesh: pmesh.Mesh | None = None, drift_margin: float = 2.0,
    plain: bool = False,
):
    """run/frontend_tiled.py's host loop on the sharded pool: each chunk of
    cfg.chunk scans activates the tiles within max_range + search_xy +
    the blur halo + `drift_margin` of the odometry forecast (from rank
    0's pose, agreed once a chunk), then runs. The tail chunk is padded by
    repeating the last record. Returns (this rank's final state, traj
    [T, 3], scores [T]), the last two numpy arrays, the same on every
    rank."""
    mesh = make_tile_mesh(mesh)
    odom = np.asarray(log["odom"], np.float32)
    ranges = np.asarray(log["ranges"], np.float32)
    T = len(odom)
    K = cfg.chunk
    state = sharded_tiled_init(tcfg, mesh, start_pose=odom[0],
                               start_odom=odom[0])
    n_pad = state.coords.shape[0] - 1
    table = TileTable(dataclasses.replace(tcfg, n_slots=n_pad))
    est, base = odom[0], odom[0]
    reach = (
        cfg.sensor.max_range + cfg.matcher.search_xy
        + blur_halo_cells(cfg.matcher, tcfg.resolution) * tcfg.resolution
        + drift_margin
    )
    n_run = -(-T // K) * K
    out = torch.empty((n_run, 4), dtype=torch.float32, device=mesh.device)
    for s in range(0, T, K):
        o = odom[s : s + K]
        r = ranges[s : s + K]
        if len(o) < K:
            pad = K - len(o)
            o = np.concatenate([o, np.repeat(o[-1:], pad, axis=0)])
            r = np.concatenate([r, np.repeat(r[-1:], pad, axis=0)])
        fx = [_np_compose(est, _np_between(base, o[t]))[:2]
              for t in range(len(o))]
        need = required_tiles(np.asarray(fx), reach, tcfg)
        grid = table.activate(TiledGrid(state.tiles, state.coords), need)
        state = state._replace(coords=grid.coords)
        state = run_sharded_tiled_chunk(state, table, o, r, cfg, tcfg, mesh,
                                        out[s : s + K], plain)
        est = _agreed_pose(state.pose, mesh)
        base = o[-1]
    out = out[:T].cpu().numpy()
    return state, out[:, :3].copy(), out[:, 3].copy()
