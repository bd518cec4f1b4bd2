"""Full SLAM on the unbounded tiled world, port of
slam2d_tpu/run/full_slam_tiled.py: the tiled frontend's tracking
(run/frontend_tiled.py), keyframe-relative loop-closure submaps, the pose
graph, and a tiled map rebuild after each correction. This is the
MIT-Killian-scale configuration: no fixed grid bounds the trajectory.

The loop closer, the submaps and the solvers are run/full_slam.py's
(submaps are built in the anchor keyframe's frame on a small
zero-centered grid, so they never depend on the world's extent). The
host loop keeps the JAX package's order of events: tiles are activated
for chunk c from an odometry forecast composed onto the pose of the last
chunk processed (one chunk stale), chunk c is run, chunk c-1 is read in
one copy and processed (keyframe admission, loop attempts), the pending
attempts are resolved, and an accept's correction is owed as a left
transform to the rows not yet emitted. A correction activates the tiles
of every corrected keyframe, then rebuilds both tile pools from the
keyframes.

The rebuild (`make_tiled_rebuild_fn`, `IncrementalTiledRebuilder`)
integrates each keyframe scan into the [win, win] window around its
pose (the tiled frontend's window, its origin the pose's global cell
minus win // 2, floored on the host from the same float32 values as
grid/tiles.world_to_cell_global) and writes back the window and its
halo-trimmed search space. The JAX package runs every slot of a chunk,
the masked (padding) slots too: their integration is a no-op, but their
search-space window, around the world cell of their pose (0, 0, 0), is
built from the map and written into the search-space pool all the same.
The port skips the masked slots' integrations and replays their
search-space writes: one build for a run of masked slots at one window
(the map does not change between them) and one write each, which gives
the JAX package's bits.

The tracking writes its tiles in place, so the rebuilder's cached prefix
pools are copies, as are a replay's starting pools and the checkpoint's
frontend state. Device-to-host reads of the driver go through
run/full_slam.fetch (`fetch.reads`); the tiled frontend reads its gates
on the host (`tiled_frontend_step.host_syncs`). Plain integers on
`run_full_slam_tiled` count the keyframe scans integrated by rebuilds
(`rebuilt_scans`), the search-space builds of the rebuilds
(`rebuilt_fields`: one an integrated scan and one a run of masked slots
at one window) and the corrections applied (`corrections`); the loop
attempts are counted on run_full_slam (`attempts`, `submaps`,
`submap_scans`). A caller may reset them.
"""

from __future__ import annotations

import numpy as np
import torch

from slam2d_tpu_torch.config import FrontendConfig, GraphConfig, MatcherConfig
from slam2d_tpu_torch.core import se2
from slam2d_tpu_torch.core.numerics import inv_f32
from slam2d_tpu_torch.graph import se2_graph
from slam2d_tpu_torch.grid.occupancy import integrate_scan, window_origin_xy
from slam2d_tpu_torch.grid.tiles import (
    FREE_SLOT,
    TileConfig,
    TiledGrid,
    TileTable,
    gather_region,
    required_tiles,
    scatter_region,
    tiled_init,
)
from slam2d_tpu_torch.grid.window import blur_halo_cells
from slam2d_tpu_torch.match.correlative import build_search_space
from slam2d_tpu_torch.run.frontend_tiled import (
    TiledFrontendState,
    _np_between,
    _np_compose,
    _param_grid_cfg,
    run_tiled_chunk,
    tiled_frontend_init,
    tiled_window_cells,
)
from slam2d_tpu_torch.run.full_slam import (
    HostLoop,
    _check_optimizer,
    _host,
    default_loop_matcher,
    fetch,
    snap_render_poses,
)


def _global_cell(p, tcfg: TileConfig) -> tuple[int, int]:
    """grid/tiles.world_to_cell_global of a host pose, in the same float32
    operations: ((x - origin) * fl32(1 / res)), floored."""
    inv = np.float32(inv_f32(tcfg.resolution))
    col = np.floor((np.float32(p[0]) - np.float32(tcfg.origin_x)) * inv)
    row = np.floor((np.float32(p[1]) - np.float32(tcfg.origin_y)) * inv)
    return int(row), int(col)


def _make_tiled_rebuild_chunk(cfg: FrontendConfig, tcfg: TileConfig, device,
                              plain: bool = False):
    """rebuild_chunk(grid, sgrid, table, poses, scans, mask): integrate one
    chunk of keyframe slots, in order, into the log-odds pool `grid` and
    refresh the search-space pool `sgrid`, both in place. `table` is the
    pools' host TileTable; `poses` [n, 3], `scans` [n, B] and `mask` [n]
    are numpy arrays or tensors (the active slots' poses and scans go to
    `device` in one copy each). A masked slot integrates nothing, but its
    halo-trimmed search-space window is written as the JAX package
    writes it (module docstring)."""
    win = tiled_window_cells(tcfg, cfg.sensor, cfg.matcher)
    halo = blur_halo_cells(cfg.matcher, tcfg.resolution)
    gparam = _param_grid_cfg(cfg, tcfg)

    def field(gw):
        run_full_slam_tiled.rebuilt_fields += 1
        S = build_search_space(gw, cfg.matcher, tcfg.resolution, plain=plain)
        return S[halo:-halo, halo:-halo]

    def rebuild_chunk(grid, sgrid, table, poses, scans, mask):
        p_host = _host(poses).astype(np.float32)
        on = _host(mask) != 0
        active = np.flatnonzero(on)
        run_full_slam_tiled.rebuilt_scans += len(active)
        p_dev = torch.as_tensor(p_host[active], device=device)
        r_dev = torch.as_tensor(_host(scans).astype(np.float32)[active],
                                device=device)
        masked = None     # (origin, trimmed S) of the last masked window
        j = 0
        for k in range(len(p_host)):
            r, c = _global_cell(p_host[k], tcfg)
            orc = (r - win // 2, c - win // 2)
            inner = (orc[0] + halo, orc[1] + halo)
            if on[k]:
                gw = gather_region(grid, tcfg, orc, win, table)
                gw = integrate_scan(
                    gw, p_dev[j], r_dev[j], gparam, cfg.sensor,
                    origin_xy=window_origin_xy(tcfg, orc), plain=plain,
                )
                j += 1
                scatter_region(grid, tcfg, gw, orc, table)
                scatter_region(sgrid, tcfg, field(gw), inner, table)
                masked = None
                continue
            if masked is None or masked[0] != orc:
                masked = (orc, field(gather_region(grid, tcfg, orc, win,
                                                   table)))
            scatter_region(sgrid, tcfg, masked[1], inner, table)

    return rebuild_chunk


def _fresh_pools(tcfg: TileConfig, table: TileTable, device, tiles=None):
    """(grid, sgrid): pools with the table's coords, their tiles zero or
    copies of `tiles` (a pair of tile tensors)."""
    coords = torch.as_tensor(table.coords.copy(), device=device)
    if tiles is None:
        return (tiled_init(tcfg, device)._replace(coords=coords),
                tiled_init(tcfg, device)._replace(coords=coords))
    return (TiledGrid(tiles[0].clone(), coords),
            TiledGrid(tiles[1].clone(), coords))


def make_tiled_rebuild_fn(cfg: FrontendConfig, tcfg: TileConfig,
                          capacity: int, chunk: int = 32, device="cuda",
                          plain: bool = False):
    """rebuild(table, poses, scans, mask, n_active=None) -> (grid, sgrid):
    integrate up to `capacity` keyframe scans into fresh pools of the
    table's tiles (the slot table kept), refreshing the search-space pool
    as well, a chunk of `chunk` slots at a time over the chunks that hold
    active keyframes."""
    rebuild_chunk = _make_tiled_rebuild_chunk(cfg, tcfg, device, plain)

    def rebuild(table, poses, scans, mask, n_active: int | None = None):
        n = capacity if n_active is None else min(int(n_active), capacity)
        n = ((max(n, 1) + chunk - 1) // chunk) * chunk
        n = min(n, capacity)
        grid, sgrid = _fresh_pools(tcfg, table, device)
        for s in range(0, n, chunk):
            rebuild_chunk(grid, sgrid, table, poses[s : s + chunk],
                          scans[s : s + chunk], mask[s : s + chunk])
        return grid, sgrid

    return rebuild


class IncrementalTiledRebuilder:
    """The tiled counterpart of full_slam.IncrementalRebuilder: replay the
    keyframe integrations from a chunk-aligned cached prefix of (tile
    pool, search-space pool) instead of fresh tiles, from the first
    keyframe whose RENDERED (snapped) pose moved. Valid because slots are
    only ever added (TileTable.activate never evicts): a slot activated
    after the snapshot holds zeros there, as a fresh tile does. The cache
    holds copies (the returned pools become the frontend's, which writes
    into them), with the slot table's coords at the snapshot."""

    def __init__(self, cfg: FrontendConfig, tcfg: TileConfig, capacity: int,
                 chunk: int = 32, eps_cells: float = 0.25, device="cuda",
                 plain: bool = False):
        self.tcfg = tcfg
        self.device = device
        self.capacity = capacity
        self.chunk = chunk
        self.eps_xy = eps_cells * tcfg.resolution
        self.eps_th = (eps_cells * tcfg.resolution
                       / max(cfg.sensor.max_range, 1e-6))
        self._rebuild_chunk = _make_tiled_rebuild_chunk(cfg, tcfg, device,
                                                        plain)
        self.map_poses = np.zeros((capacity, 3), np.float32)
        self.n_prev = 0
        self.cache = None          # (tiles, stiles, coords_np) at cache_k
        self.cache_k = 0

    def restore(self, map_poses, n_prev: int):
        self.map_poses[: len(map_poses)] = np.asarray(map_poses, np.float32)
        self.n_prev = int(n_prev)
        self.cache = None
        self.cache_k = 0

    def _cache_compatible(self, coords_np):
        """Every slot active at the snapshot still holds the same tile."""
        old = self.cache[2]
        act = old[:, 0] > FREE_SLOT
        return bool(np.array_equal(old[act], coords_np[act]))

    def __call__(self, table: TileTable, poses, scans, mask,
                 n_active: int | None = None):
        n = (self.capacity if n_active is None
             else min(int(n_active), self.capacity))
        n = max(n, 1)
        poses, k0 = snap_render_poses(
            _host(poses), n, self.map_poses, self.n_prev, self.eps_xy,
            self.eps_th,
        )
        coords_np = table.coords.copy()
        if (
            self.cache is not None
            and self.cache_k <= k0
            and self._cache_compatible(coords_np)
        ):
            grid, sgrid = _fresh_pools(self.tcfg, table, self.device,
                                       self.cache[:2])
            start = self.cache_k
        else:
            grid, sgrid = _fresh_pools(self.tcfg, table, self.device)
            start = 0
            self.cache, self.cache_k = None, 0
        n_end = min(((n + self.chunk - 1) // self.chunk) * self.chunk,
                    self.capacity)
        for s in range(start, n_end, self.chunk):
            self._rebuild_chunk(
                grid, sgrid, table, poses[s : s + self.chunk],
                scans[s : s + self.chunk], mask[s : s + self.chunk],
            )
            # the returned pools are never the cache: they become the
            # frontend's
            if s + self.chunk <= k0 and s + self.chunk < n_end:
                self.cache = (grid.tiles.clone(), sgrid.tiles.clone(),
                              coords_np)
                self.cache_k = s + self.chunk
        self.map_poses[:n] = poses[:n]
        self.n_prev = n
        return grid, sgrid


def fullslam_tiled_ckpt_template(cfg: FrontendConfig, tcfg: TileConfig,
                                 graph_cfg: GraphConfig):
    """The checkpoint's schema, as numpy arrays of its fixed shapes:
    full_slam.fullslam_ckpt_template's, with the tiled frontend's state
    (both tile pools with their coords; the host TileTable is rebuilt
    from the coords on resume). A run's `ckpt` holds tensors for
    "frontend" and "graph" and numpy arrays elsewhere; `resume` takes
    either."""
    n, t = tcfg.n_slots + 1, tcfg.tile
    g = se2_graph.HostGraph(graph_cfg)
    Kmax = graph_cfg.max_nodes

    def pool():
        return TiledGrid(np.zeros((n, t, t), np.float32),
                         np.full((n, 2), FREE_SLOT, np.int32))

    return {
        "frontend": TiledFrontendState(
            pool(), pool(), np.zeros(3, np.float32), np.zeros(3, np.float32),
            np.float32(0.0), np.zeros(3, np.float32),
            np.zeros(2, np.float32),
        ),
        "graph": se2_graph.PoseGraph(
            g.poses, g.node_mask, np.int32(0), g.edges_ij, g.edges_z,
            g.edges_omega, g.edge_mask, np.int32(0),
        ),
        "kf_poses": np.zeros((Kmax, 3), np.float32),
        "kf_scans": np.zeros((Kmax, cfg.sensor.n_beams), np.float32),
        "kf_scan_idx": np.zeros(Kmax, np.int32),
        "kf_count": np.int32(0),
        "last_kf_pose": np.zeros(3, np.float32),
        "loops": np.zeros((graph_cfg.max_edges, 6), np.float32),
        "n_loops": np.int32(0),
        "chi2": np.float32(0.0),
        "cooldown": np.int32(0),
        "map_poses": np.zeros((Kmax, 3), np.float32),
        "map_pose_count": np.int32(0),
        "loop_cache_anchor": np.int32(-1),
    }


def _owned_state(state, device) -> TiledFrontendState:
    """A TiledFrontendState on `device` owning copies of `state`'s arrays
    (tensors or numpy)."""
    def own(x, dtype):
        if isinstance(x, torch.Tensor):
            return x.to(device=device, dtype=dtype, copy=True)
        return torch.tensor(np.asarray(x), dtype=dtype, device=device)

    grid, sgrid, *rest = state
    return TiledFrontendState(
        *(TiledGrid(own(p[0], torch.float32), own(p[1], torch.int32))
          for p in (grid, sgrid)),
        *(own(x, torch.float32) for x in rest),
    )


def run_full_slam_tiled(
    log: dict,
    cfg: FrontendConfig,
    tcfg: TileConfig,
    graph_cfg: GraphConfig,
    loop_matcher: MatcherConfig | None = None,
    submap_halfwidth: int = 3,
    odom_edge_info: float = 50.0,
    loop_edge_info: float = 200.0,
    drift_margin: float = 2.0,
    optimizer: str = "auto",
    resume: dict | None = None,
    scan_index_offset: int = 0,
    incremental_rebuild: bool = True,
    defer_accept: bool = True,
    device="cuda",
    plain: bool = False,
):
    """Run full SLAM on the tiled world over a host-side log {odom,
    ranges} on `device`; returns a FullSLAMResult whose `grid` is the
    log-odds TiledGrid (grid/tiles.stitch_tiles makes it one array).

    optimizer: "dense", "schur" (graph/schur.py, 4 blocks) or "auto"
    (dense up to full_slam.DENSE_MAX_KEYFRAMES keyframes); the JAX
    package's other solvers raise NotImplementedError. resume /
    scan_index_offset: continue from a previous run's `ckpt` (or numpy
    arrays of fullslam_tiled_ckpt_template's schema), as in run_full_slam;
    the resumed state is copied. `plain=True` runs every kernel's plain
    version (checks only)."""
    _check_optimizer(optimizer)
    odom_np = np.asarray(log["odom"], np.float32)
    ranges_np = np.asarray(log["ranges"], np.float32)
    T = len(odom_np)
    K = cfg.chunk

    rebuild_tiles = IncrementalTiledRebuilder(
        cfg, tcfg, graph_cfg.max_nodes,
        # eps 0: nothing snaps, every rebuild replays from fresh tiles
        eps_cells=0.25 if incremental_rebuild else 0.0,
        device=device, plain=plain,
    )
    reach = (
        cfg.sensor.max_range + cfg.matcher.search_xy
        + blur_halo_cells(cfg.matcher, tcfg.resolution) * tcfg.resolution
        + drift_margin
    )
    if resume is not None:
        state = _owned_state(resume["frontend"], device)
        table = TileTable.from_coords(tcfg, resume["frontend"][0][1])
        rebuild_tiles.restore(resume["map_poses"], resume["map_pose_count"])
    else:
        state = tiled_frontend_init(tcfg, device, start_pose=odom_np[0],
                                    start_odom=odom_np[0])
        table = TileTable(tcfg)

    def apply_correction(corr_np):
        # activate the tiles of every corrected keyframe, rebuild both
        # pools and patch the live frontend; `corr_np` is the LEFT
        # correction transform, valid on the device pose even when it has
        # run a chunk past `est`
        nonlocal state
        run_full_slam_tiled.corrections += 1
        Tc = torch.as_tensor(corr_np, dtype=torch.float32, device=device)
        kf_poses = np.stack(host.kf_poses)
        table.activate(state.grid, required_tiles(kf_poses[:, :2], reach,
                                                  tcfg))
        Kmax = graph_cfg.max_nodes
        nk = len(kf_poses)
        poses_buf = np.zeros((Kmax, 3), np.float32)
        scans_buf = np.zeros((Kmax, ranges_np.shape[1]), np.float32)
        mask_buf = np.zeros(Kmax, np.float32)
        poses_buf[:nk] = kf_poses
        scans_buf[:nk] = np.stack(host.kf_scans)
        mask_buf[:nk] = 1.0
        new_grid, new_sgrid = rebuild_tiles(table, poses_buf, scans_buf,
                                            mask_buf, n_active=nk)
        new_pose = se2.compose(Tc, state.pose)
        state = state._replace(
            grid=new_grid, sgrid=new_sgrid, pose=new_pose,
            last_map_pose=new_pose.clone(),
        )

    host = HostLoop(
        cfg, graph_cfg, loop_matcher or default_loop_matcher(graph_cfg),
        submap_halfwidth, ranges_np, optimizer, odom_edge_info,
        loop_edge_info, scan_index_offset, apply_correction, resume,
        defer_accept, device=device, plain=plain,
    )
    host.est, host.base = fetch(state.pose, state.prev_odom)
    # the host loop over chunks: activate chunk c's tiles from the
    # forecast, run chunk c, then process chunk c-1 and resolve the
    # pending attempts (HostLoop.step). The forecast composes the
    # odometry onto the estimate of the last PROCESSED chunk (est, base):
    # one chunk of staleness, well inside `reach`'s margin.
    for s0 in range(0, T, K):
        o = odom_np[s0 : s0 + K]
        r = ranges_np[s0 : s0 + K]
        if len(o) < K:
            pad = K - len(o)
            o = np.concatenate([o, np.repeat(o[-1:], pad, axis=0)])
            r = np.concatenate([r, np.repeat(r[-1:], pad, axis=0)])
        fx = [_np_compose(host.est, _np_between(host.base, o[t]))[:2]
              for t in range(len(o))]
        grid = table.activate(state.grid, required_tiles(
            np.asarray(fx), reach, tcfg))
        state = state._replace(grid=grid,
                               sgrid=state.sgrid._replace(coords=grid.coords))
        out = torch.empty((K, 4), dtype=torch.float32, device=device)
        state = run_tiled_chunk(state, table, o, r, cfg, tcfg, out, plain)
        host.step({"s0": s0, "n": min(K, T - s0), "tr": out[:, :3],
                   "pose": state.pose, "base": o[-1]})
    host.finish()
    ckpt = host.checkpoint(
        fullslam_tiled_ckpt_template(cfg, tcfg, graph_cfg), rebuild_tiles,
        _owned_state(state, device), device,
    )
    return host.result(state.grid, ckpt)


run_full_slam_tiled.rebuilt_scans = 0
run_full_slam_tiled.rebuilt_fields = 0
run_full_slam_tiled.corrections = 0
