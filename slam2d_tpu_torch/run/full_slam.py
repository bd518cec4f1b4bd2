"""Full SLAM on a bounded grid: frontend + keyframes + loop closure +
pose-graph backend, port of slam2d_tpu/run/full_slam.py.

The host owns the control flow (keyframe admission, loop gating, when to
optimize); the dense work runs on the tensors' device:

- tracking: run/frontend.py's step, a chunk of scans at a time (on CUDA
  one replay of the frontend's CUDA graph, `run_chunk`);
- loop candidates: a wide-window correlative match of the new keyframe's
  scan against a submap rebuilt from the old keyframe's neighbourhood, in
  that keyframe's frame (kernels 1 `hybrid`, 3 and 2 at the submap's and
  the loop matcher's shapes);
- the graph solve: graph/se2_graph.py (dense Gauss-Newton),
  graph/schur.py (block Schur elimination) or graph/sparse.py (the
  matrix-free PCG solver and the hierarchical one);
- the map rebuild after a correction: every keyframe scan integrated again
  at its corrected pose, replayed from a cached prefix where the poses did
  not move.

Loop edges: z_ij = (Xi_est)^-1 ⊞ matched_Xj, the matched pose of keyframe
j in the submap built in keyframe i's frame.

The host loop keeps the JAX package's order of events: chunk c is run,
then chunk c-1's poses are read and processed (keyframe admission and
loop attempts one chunk behind), then the pending attempts are resolved
in one read; an accepted loop's solve is dispatched and finalized at the
next chunk boundary (`defer_accept`), its correction left-applied to the
rows not yet processed. The frontend reads nothing back during a chunk
(its gates are on the device), but a read of chunk c-1 waits for chunk
c, enqueued before it: the order is kept for the function it computes,
not for overlap.
Device-to-host reads of this module go through `fetch` and are counted in
`fetch.reads`.

The frontend writes its map in place (grid/window.py), so every map this
module keeps beside the live one is a copy: the rebuilder's cached prefix
(copied when cached and when replayed from), the map handed to `frame_cb`
and the checkpoint's frontend state. Every optimizer of the JAX package
runs ("dense", "schur", "schur_sharded", "sparse", "hier" and "auto").
Under "schur_sharded" every rank of a mesh (parallel/mesh.py) runs the
whole loop; before each solve rank 0 broadcasts a header (the keyframe and
edge counts) and then the graph, so that every rank solves the same
bits, and a rank whose header differs raises.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from slam2d_tpu_torch.config import (
    FrontendConfig,
    GraphConfig,
    GridConfig,
    MatcherConfig,
)
from slam2d_tpu_torch.core import se2
from slam2d_tpu_torch.core.numerics import inv_f32
from slam2d_tpu_torch.graph import schur, se2_graph, sparse
from slam2d_tpu_torch.grid.occupancy import integrate_scan, make_grid
from slam2d_tpu_torch.grid.window import (
    extract_window,
    update_window_cells,
    write_window,
)
from slam2d_tpu_torch.parallel import mesh as pmesh
from slam2d_tpu_torch.match.correlative import (
    build_search_space,
    match_scan,
    peak_uniqueness,
)
from slam2d_tpu_torch.run.frontend import (
    FrontendState,
    _pad_log,
    frontend_init,
    run_chunk,
)
from slam2d_tpu_torch.run.frontend_tiled import (
    _np_between,
    _np_between_batch,
    _np_compose,
    _np_compose_batch,
    _np_inverse,
)

# keyframe counts up to which optimizer="auto" runs the dense solver; above
# it, as the JAX package, the hierarchical one (graph/sparse.py)
DENSE_MAX_KEYFRAMES = 1024
SCHUR_BLOCKS = 4   # the JAX package's n_blocks for optimizer="schur"

# Opt-in accept-path phase profiler: a utils/profiling.PhaseTimer, or None
# (the default: no cost, no extra syncs). Given one (each phase boundary
# synchronizes the card), the accept path records
# its phases at the JAX package's names: "accept/graph_to_device" (the
# HostGraph copied to the device), "accept/optimize+fetch" (the solve and
# the read of its poses, attributed together) and
# "accept/retro_correct_host" (the trajectory's retro-correction).
ACCEPT_TIMER = None


def _accept_phase(name: str):
    if ACCEPT_TIMER is None:
        return contextlib.nullcontext()
    return ACCEPT_TIMER.phase(name)


OPTIMIZERS = ("auto", "dense", "schur", "schur_sharded", "sparse", "hier")


def _check_optimizer(optimizer: str) -> None:
    if optimizer not in OPTIMIZERS:
        raise ValueError(f"unknown optimizer {optimizer!r}")


def solve_mesh(mesh):
    """The mesh of "schur_sharded": `mesh`, else the one this process
    joined, else None (a process of its own: the JAX package's mesh over
    the one visible device, one block)."""
    return mesh or pmesh.joined()


def agree_graph(host, mesh):
    """`host` (a HostGraph) as rank 0 holds it, on every rank: rank 0
    broadcasts a header of its node and edge counts, which every rank
    checks against its own (a rank whose header differs raises), then
    the graph's arrays. Returns a HostGraph of rank 0's bits (`host`
    itself in a world of one)."""
    if mesh.world_size == 1:
        return host
    dev = mesh.device
    mine = torch.tensor([host.n_nodes, host.n_edges], dtype=torch.int64,
                        device=dev)
    head = mesh.broadcast(mine, 0)
    if not torch.equal(head, mine):
        raise RuntimeError(
            f"rank {mesh.rank}: graph header {mine.tolist()} differs from "
            f"rank 0's {head.tolist()}: the ranks' runs diverged")
    out = copy.copy(host)
    for name in ("poses", "node_mask", "edges_ij", "edges_z", "edges_omega",
                 "edge_mask"):
        a = getattr(host, name)
        t = torch.as_tensor(a.astype(np.uint8) if a.dtype == bool else a,
                            device=dev)
        b = mesh.broadcast(t, 0).cpu().numpy()
        setattr(out, name, b.astype(bool) if a.dtype == bool else b)
    return out


def fetch(*tensors):
    """One device-to-host copy of `tensors` (each flattened to float32 and
    concatenated), counted in `fetch.reads`. Returns numpy arrays of the
    tensors' shapes, in float32 (bool tensors come back as bool)."""
    fetch.reads += 1
    flat = torch.cat([t.reshape(-1).to(torch.float32) for t in tensors])
    host = flat.cpu().numpy()
    out, i = [], 0
    for t in tensors:
        n = t.numel()
        a = host[i : i + n].reshape(t.shape)
        out.append(a.astype(bool) if t.dtype == torch.bool else a)
        i += n
    return out


fetch.reads = 0


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _cell_of(p, gcfg: GridConfig) -> tuple[int, int]:
    """grid/occupancy.world_to_cell of a host pose, in the same float32
    operations: ((x - origin) * fl32(1 / res)), floored."""
    inv = np.float32(inv_f32(gcfg.resolution))
    col = np.floor((np.float32(p[0]) - np.float32(gcfg.origin_x)) * inv)
    row = np.floor((np.float32(p[1]) - np.float32(gcfg.origin_y)) * inv)
    return int(row), int(col)


def _make_rebuild_chunk(cfg: FrontendConfig, gcfg: GridConfig, device,
                        plain: bool = False):
    """rebuild_chunk(grid, poses, scans, mask) -> grid: integrate the scans
    of one chunk of keyframe slots, in order, into `grid`.

    `poses` [n, 3], `scans` [n, B] and `mask` [n] are numpy arrays or
    tensors; the active slots' poses and scans go to `device` in one copy
    each. A keyframe's scan only touches cells within
    max_range of its pose, so where that window is smaller than the grid
    it is integrated into the window and written back in place (the
    returned grid is `grid`); else into the whole grid (a new tensor).
    Slots with mask 0 are skipped: the JAX package runs them with enable
    0, which gives back the map unchanged (a clip of clamped values), so
    the map is the same and the launches are those of the active slots."""
    uwin = update_window_cells(gcfg, cfg.sensor)
    windowed = uwin < min(gcfg.height, gcfg.width)

    def rebuild_chunk(grid, poses, scans, mask):
        active = np.flatnonzero(_host(mask) != 0)
        if not len(active):
            return grid
        run_full_slam.rebuilt_scans += len(active)
        p_host = _host(poses).astype(np.float32)[active]
        p_dev = torch.as_tensor(p_host, device=device)
        r_dev = torch.as_tensor(_host(scans).astype(np.float32)[active],
                                device=device)
        for k in range(len(active)):
            if not windowed:
                grid = integrate_scan(grid, p_dev[k], r_dev[k], gcfg,
                                      cfg.sensor, plain=plain)
                continue
            gw, orc = extract_window(grid, _cell_of(p_host[k], gcfg), uwin)
            gw = integrate_scan(gw, p_dev[k], r_dev[k], gcfg, cfg.sensor,
                                origin_rc=orc, plain=plain)
            write_window(grid, gw, orc)
        return grid

    return rebuild_chunk


def make_rebuild_fn(cfg: FrontendConfig, capacity: int, grid_cfg=None,
                    chunk: int = 32, device="cuda", plain: bool = False):
    """rebuild(poses, scans, mask, n_active=None): integrate up to
    `capacity` keyframe scans into a fresh grid, a chunk of `chunk` slots
    at a time over the chunks that hold active keyframes."""
    gcfg = grid_cfg or cfg.grid
    rebuild_chunk = _make_rebuild_chunk(cfg, gcfg, device, plain)

    def rebuild(poses, scans, mask, n_active: int | None = None):
        n = capacity if n_active is None else min(int(n_active), capacity)
        n = ((max(n, 1) + chunk - 1) // chunk) * chunk
        n = min(n, capacity)
        grid = make_grid(gcfg, device)
        for s in range(0, n, chunk):
            grid = rebuild_chunk(grid, poses[s : s + chunk],
                                 scans[s : s + chunk], mask[s : s + chunk])
        return grid

    return rebuild


def snap_render_poses(poses, n, map_poses, n_prev, eps_xy, eps_th):
    """Snap sub-eps pose corrections to the previously RENDERED pose.

    Returns (snapped poses copy, k0), k0 the first keyframe whose rendered
    pose changed (== min(n, n_prev) when none did). Mutates nothing."""
    poses = np.array(poses, np.float32, copy=True)
    m = min(n, n_prev)
    if m == 0:
        return poses, 0
    d = np.hypot(
        poses[:m, 0] - map_poses[:m, 0], poses[:m, 1] - map_poses[:m, 1]
    )
    dth = (poses[:m, 2] - map_poses[:m, 2] + np.pi) % (2 * np.pi) - np.pi
    same = (d <= eps_xy) & (np.abs(dth) <= eps_th)
    poses[:m][same] = map_poses[:m][same]
    k0 = m if bool(same.all()) else int(np.argmax(~same))
    return poses, k0


class IncrementalRebuilder:
    """Post-loop map rebuild that integrates again only the keyframes whose
    RENDERED pose moved: sub-quarter-cell corrections snap to the
    previously rendered pose, and the integration replays from a cached,
    chunk-aligned prefix grid up to the first keyframe that moved. The
    result is bit-exact against a from-scratch rebuild at the same snapped
    poses (the same integrations in the same order from the same empty
    grid).

    The rebuild writes into its working grid in place, so the cached
    prefix is a copy, and a replay starts from a copy of it: the returned
    grid becomes the frontend's map, which the frontend then writes into.
    The render poses ride in the checkpoint ("map_poses"); the prefix grid
    does not, and the first rebuild after a resume replays from empty."""

    def __init__(self, cfg: FrontendConfig, capacity: int, grid_cfg=None,
                 chunk: int = 32, eps_cells: float = 0.25, device="cuda",
                 plain: bool = False):
        gcfg = grid_cfg or cfg.grid
        self.gcfg = gcfg
        self.device = device
        self.capacity = capacity
        self.chunk = chunk
        self.eps_xy = eps_cells * gcfg.resolution
        self.eps_th = eps_cells * gcfg.resolution / max(cfg.sensor.max_range, 1e-6)
        self._rebuild_chunk = _make_rebuild_chunk(cfg, gcfg, device, plain)
        self.map_poses = np.zeros((capacity, 3), np.float32)
        self.n_prev = 0
        self.cache_grid = None
        self.cache_k = 0

    def restore(self, map_poses, n_prev: int):
        self.map_poses[: len(map_poses)] = np.asarray(map_poses, np.float32)
        self.n_prev = int(n_prev)
        self.cache_grid = None
        self.cache_k = 0

    def __call__(self, poses, scans, mask, n_active: int | None = None):
        n = self.capacity if n_active is None else min(int(n_active), self.capacity)
        n = max(n, 1)
        poses, k0 = snap_render_poses(
            _host(poses), n, self.map_poses, self.n_prev, self.eps_xy, self.eps_th,
        )
        if self.cache_grid is not None and self.cache_k <= k0:
            grid, start = self.cache_grid.clone(), self.cache_k
        else:
            grid, start = make_grid(self.gcfg, self.device), 0
            self.cache_grid, self.cache_k = None, 0
        n_end = min(((n + self.chunk - 1) // self.chunk) * self.chunk,
                    self.capacity)
        for s in range(start, n_end, self.chunk):
            grid = self._rebuild_chunk(
                grid, poses[s : s + self.chunk], scans[s : s + self.chunk],
                mask[s : s + self.chunk],
            )
            # the returned grid is never the cache: it becomes the
            # frontend's map
            if s + self.chunk <= k0 and s + self.chunk < n_end:
                self.cache_grid, self.cache_k = grid.clone(), s + self.chunk
        self.map_poses[:n] = poses[:n]
        self.n_prev = n
        return grid


def default_submap_grid(cfg: FrontendConfig) -> GridConfig:
    """Zero-centered grid for keyframe-RELATIVE submaps: the sensor's reach
    plus the loop search radius around the anchor keyframe."""
    half_m = cfg.sensor.max_range * 2.0 + 4.0
    size = int(math.ceil(2 * half_m / cfg.grid.resolution / 128)) * 128
    return dataclasses.replace(
        cfg.grid, height=size, width=size, center_x=0.0, center_y=0.0
    )


def make_loop_attempt_fns(cfg: FrontendConfig, loop_matcher: MatcherConfig,
                          grid_cfg: GridConfig, device="cuda",
                          plain: bool = False):
    """(attempt_full, attempt_cached): a loop-closure attempt and the
    rescoring of a new scan against a cached submap.

    attempt_full(poses, scans, mask, ranges, prior) integrates the active
    slots' scans (host arrays; poses relative to the anchor keyframe) into
    a fresh, unwindowed submap of `grid_cfg`, builds its search space on
    all of it, and runs the wide-window match and the peak-uniqueness
    margin of `ranges` from `prior` (host arrays). It returns (grid, S,
    pose, score, margin) as tensors, so the caller can cache (grid, S).
    attempt_cached(grid, S, ranges, prior) returns (pose, score, margin).
    Nothing is read back to the host. Masked slots are skipped (see
    _make_rebuild_chunk)."""
    gcfg = grid_cfg

    def as_dev(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    def score(grid, S, ranges, prior):
        run_full_slam.attempts += 1
        r, p = as_dev(ranges), as_dev(prior)
        pose, sc = match_scan(grid, r, p, gcfg, loop_matcher, cfg.sensor,
                              search_space=S, plain=plain)
        margin = peak_uniqueness(grid, r, p, gcfg, loop_matcher, cfg.sensor,
                                 search_space=S, plain=plain)
        return pose, sc, margin

    def attempt_full(poses, scans, mask, ranges, prior):
        grid = make_grid(gcfg, device)
        active = np.flatnonzero(_host(mask) != 0)
        run_full_slam.submaps += 1
        run_full_slam.submap_scans += len(active)
        p_dev = as_dev(_host(poses)[active])
        r_dev = as_dev(_host(scans)[active])
        for k in range(len(active)):
            grid = integrate_scan(grid, p_dev[k], r_dev[k], gcfg, cfg.sensor,
                                  plain=plain)
        S = build_search_space(grid, loop_matcher, gcfg.resolution,
                               plain=plain)
        return (grid, S) + score(grid, S, ranges, prior)

    def attempt_cached(grid, S, ranges, prior):
        return score(grid, S, ranges, prior)

    return attempt_full, attempt_cached


class FullSLAMResult(NamedTuple):
    traj: np.ndarray          # [T, 3] per-scan trajectory (post-corrections)
    kf_poses: np.ndarray      # [K, 3] final keyframe poses
    kf_scan_idx: np.ndarray   # [K] scan index of each keyframe
    n_loops: int
    grid: torch.Tensor        # final [H, W] log-odds map
    chi2: float
    # accepted loop records: (i, j, score, zx, zy, ztheta) per loop
    loops: np.ndarray = np.zeros((0, 6), np.float32)
    # every ATTEMPTED loop closure: (i, j, score, peak_margin, corr_xy,
    # corr_theta, accepted, zx, zy, ztheta), z* the measured pose i -> j
    loop_attempts: np.ndarray = np.zeros((0, 10), np.float32)
    # resumable pipeline snapshot (fullslam_ckpt_template's schema); pass
    # back as `resume=`
    ckpt: dict | None = None


def fullslam_ckpt_template(cfg: FrontendConfig, graph_cfg: GraphConfig):
    """The checkpoint's schema, as numpy arrays of its fixed shapes (all
    zero): what `run_full_slam(..., resume=...)` expects. Everything the
    host loop owns: the frontend state (a FrontendState), the pose graph
    (a PoseGraph), the keyframe store (poses, scans and scan indices,
    padded to max_nodes), the loop records, the admission and cooldown
    counters, the rebuilder's render poses and the loop closer's submap
    anchor. A run's `ckpt` holds tensors for "frontend" and "graph" and
    numpy arrays elsewhere; `resume` takes either."""
    Kmax = graph_cfg.max_nodes
    B = cfg.sensor.n_beams
    H, W = cfg.grid.height, cfg.grid.width
    g = se2_graph.HostGraph(graph_cfg)
    return {
        "frontend": FrontendState(
            np.zeros((H, W), np.float32), np.zeros((H, W), np.float32),
            np.zeros(3, np.float32), np.zeros(3, np.float32),
            np.float32(0.0), np.zeros(3, np.float32),
            np.zeros(2, np.float32),
        ),
        "graph": se2_graph.PoseGraph(
            g.poses, g.node_mask, np.int32(0), g.edges_ij, g.edges_z,
            g.edges_omega, g.edge_mask, np.int32(0),
        ),
        "kf_poses": np.zeros((Kmax, 3), np.float32),
        "kf_scans": np.zeros((Kmax, B), np.float32),
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


def default_loop_matcher(graph_cfg: GraphConfig) -> MatcherConfig:
    return MatcherConfig(
        search_xy=graph_cfg.loop_radius / 2.0,
        search_theta=0.5,
        n_theta=41,
        coarse_factor=8,
        prior_xy_weight=0.0,       # loop search must not be pulled to the prior
        prior_theta_weight=0.0,
        min_score=0.0,
    )


def _retro_correct_traj(
    traj_out, kf_scan_idx, old_kf, corrected, upto_scan, offset=0
):
    """Apply pose-graph corrections to already-emitted per-scan poses:
    every scan between keyframe k and k+1 moves rigidly with keyframe k
    (left-multiplied by corrected_k ⊕ old_k^-1). `offset` maps absolute
    keyframe scan indices to this run's rows (rows of a previous run of a
    resumed log are clamped away)."""
    nk = len(kf_scan_idx)
    for k in range(nk):
        lo = max(kf_scan_idx[k] - offset, 0)
        hi = (kf_scan_idx[k + 1] - offset) if k + 1 < nk else upto_scan + 1
        if lo >= hi:
            continue
        o = old_kf[k]
        c = corrected[k]
        co, so = np.cos(o[2]), np.sin(o[2])
        seg = traj_out[lo:hi].copy()
        dx = seg[:, 0] - o[0]
        dy = seg[:, 1] - o[1]
        bx = co * dx + so * dy
        by = -so * dx + co * dy
        bth = seg[:, 2] - o[2]
        cc, sc = np.cos(c[2]), np.sin(c[2])
        traj_out[lo:hi, 0] = c[0] + cc * bx - sc * by
        traj_out[lo:hi, 1] = c[1] + sc * bx + cc * by
        traj_out[lo:hi, 2] = (c[2] + bth + np.pi) % (2 * np.pi) - np.pi


class LoopCloser:
    """Loop-closure machinery of run_full_slam: spatial anchor
    selection with a cached submap, attempt dispatch, batched verdict
    resolution, the acceptance gates, the graph solve with its chi^2
    prune, trajectory retro-correction and the frontend-pose transport.
    run_full_slam supplies `apply_correction(Tc)`, the map rebuild and the
    frontend-state patch.

    `issue` only enqueues an attempt's device work; `resolve` reads every
    pending verdict in one host read at the next chunk boundary, applies
    the gates in order (the first accept wins; later pending attempts
    inside its cooldown drop, later ones are issued again against the
    corrected state) and, with `defer_accept`, dispatches an accept's
    solve there and finishes its bookkeeping at the boundary after.
    Attempts requested while an accept is in flight queue
    (`deferred_issues`) and are issued after it lands. kf_poses, kf_scans
    and kf_scan_idx are run_full_slam's live lists, changed in place on an
    accept."""

    def __init__(self, cfg, graph_cfg, loop_matcher, submap_cfg,
                 submap_halfwidth, graph, kf_poses, kf_scans, kf_scan_idx,
                 ranges_np, traj_out, optimizer, loop_edge_info,
                 scan_index_offset, apply_correction, loop_records,
                 n_loops=0, chi2=0.0, cache_anchor=-1, defer_accept=True,
                 device="cuda", plain=False, mesh=None):
        self.cfg = cfg
        self.mesh = mesh
        self.gcfg = graph_cfg
        self.hw = submap_halfwidth
        self.graph = graph
        self.kf_poses = kf_poses
        self.kf_scans = kf_scans
        self.kf_scan_idx = kf_scan_idx
        self.ranges_np = ranges_np
        self.traj_out = traj_out
        self.optimizer = optimizer
        self.loop_edge_info = loop_edge_info
        self.scan_index_offset = scan_index_offset
        self.apply_correction = apply_correction
        self.loop_records = loop_records
        self.device = device
        self.attempt_records: list = []
        self.n_loops = n_loops
        self.chi2 = chi2
        # submap cache: the anchor keyframe index (checkpointed) and its
        # (grid, search space) tensors, valid until the next accepted loop
        # or until the robot leaves the anchor's loop radius
        self.cache_anchor = cache_anchor
        self.cache_gs = None
        self.pending: list = []
        self.defer_accept = defer_accept
        self.pending_accept: dict | None = None
        # the last accepted loop's newer keyframe: where the drift-relative
        # plausibility bound measures the path from (-1: none yet)
        self.last_accept_k = (
            max(int(r[1]) for r in loop_records) if loop_records else -1
        )
        self.deferred_issues: list = []
        self.n_pruned = 0
        self.attempt_full, self.attempt_cached = make_loop_attempt_fns(
            cfg, loop_matcher, submap_cfg, device, plain
        )

    def find_loop(self, k_new: int):
        """Spatial gate: nearest old keyframe within loop_radius, index
        gap >= loop_min_gap. Returns candidate index or None."""
        if k_new < self.gcfg.loop_min_gap:
            return None
        p = self.kf_poses[k_new]
        old = np.stack(self.kf_poses[: k_new - self.gcfg.loop_min_gap + 1])
        d = np.hypot(old[:, 0] - p[0], old[:, 1] - p[1])
        i = int(np.argmin(d))
        return i if d[i] <= self.gcfg.loop_radius else None

    def issue(self, k_new: int, scan_i: int):
        """Dispatch a loop-closure attempt without waiting for its result,
        against the cached anchor while the new keyframe stays inside its
        loop radius (and keeps the index gap)."""
        if self.pending_accept is not None:
            # an accept is in flight: the prior would be stale
            self.deferred_issues.append((k_new, scan_i))
            return
        i = None
        if (
            self.cache_anchor >= 0
            and k_new - self.cache_anchor >= self.gcfg.loop_min_gap
        ):
            a = self.kf_poses[self.cache_anchor]
            p = self.kf_poses[k_new]
            if np.hypot(a[0] - p[0], a[1] - p[1]) <= self.gcfg.loop_radius:
                i = self.cache_anchor
        if i is None:
            i = self.find_loop(k_new)
            self.cache_anchor = i if i is not None else -1
            self.cache_gs = None
        if i is None:
            return
        anchor = self.kf_poses[i]
        prior_rel = _np_between(anchor, self.kf_poses[k_new])
        if self.cache_gs is None:
            # the submap of keyframe i's neighbourhood in keyframe i's
            # frame, in buffers of the submap's capacity
            lo = max(0, i - self.hw)
            hi = min(len(self.kf_poses), i + self.hw + 1)
            cap = 2 * self.hw + 2
            rel = _np_between_batch(anchor, np.stack(self.kf_poses[lo:hi]))
            poses_buf = np.zeros((cap, 3), np.float32)
            scans_buf = np.zeros((cap, self.ranges_np.shape[1]), np.float32)
            mask_buf = np.zeros(cap, np.float32)
            nsub = hi - lo
            poses_buf[:nsub] = rel
            scans_buf[:nsub] = np.stack(self.kf_scans[lo:hi])
            mask_buf[:nsub] = 1.0
            g_d, S_d, pose_d, score_d, margin_d = self.attempt_full(
                poses_buf, scans_buf, mask_buf, self.ranges_np[scan_i],
                prior_rel,
            )
            self.cache_gs = (g_d, S_d)
        else:
            pose_d, score_d, margin_d = self.attempt_cached(
                self.cache_gs[0], self.cache_gs[1], self.ranges_np[scan_i],
                prior_rel,
            )
        self.pending.append({
            "i": i, "k_new": k_new, "scan_i": scan_i,
            "prior_rel": np.asarray(prior_rel),
            "outs": (pose_d, score_d, margin_d),
        })

    def _read_pending(self):
        """Every pending attempt's (matched_rel [3], score, margin), in one
        host read."""
        rows = [
            torch.cat([torch.as_tensor(x, dtype=torch.float32).reshape(-1)
                       for x in a["outs"]])
            for a in self.pending
        ]
        (host,) = fetch(torch.stack(rows))
        return [(h[:3], h[3], h[4]) for h in host]

    def resolve(self, est, emitted_upto):
        """Read every pending attempt in one host read and apply the gates;
        the first accept wins, later pending attempts inside its cooldown
        horizon drop and ones beyond it are issued again.

        Returns (cooldown | None, est, last_kf_pose | None, T_acc | None):
        the caller adopts a non-None cooldown and admission reference,
        always the returned est, and left-applies T_acc (the composed
        correction of every accept finalized here) to the chunk outputs it
        has run but not yet processed."""
        new_last_kf = None
        T_acc = None
        deferred_issues: list = []
        if self.pending_accept is not None:
            # finalize the accept dispatched at the previous boundary
            est, new_last_kf, T_acc = self._finalize_accept(
                est, emitted_upto
            )
            deferred_issues = self.deferred_issues
            self.deferred_issues = []
        if not self.pending:
            for k, s in deferred_issues:
                self.issue(k, s)
            return None, est, new_last_kf, T_acc
        outs = self._read_pending()
        batch = [(a, o) for a, o in zip(list(self.pending), outs)]
        self.pending.clear()
        accepted_k = None
        new_cooldown = None
        reissue = []
        for a, (matched_rel, score, margin) in batch:
            if accepted_k is not None:
                if a["k_new"] - accepted_k > self.gcfg.loop_cooldown:
                    reissue.append(a)
                continue
            # the correction implied on the estimate (plausibility gate)
            corr = _np_between(a["prior_rel"], matched_rel)
            attempt = [float(a["i"]), float(a["k_new"]), float(score),
                       float(margin), float(np.hypot(corr[0], corr[1])),
                       float(abs(corr[2])), 0.0,
                       float(matched_rel[0]), float(matched_rel[1]),
                       float(matched_rel[2])]
            self.attempt_records.append(attempt)
            if float(score) < self.gcfg.loop_score_accept:
                continue
            if float(margin) < self.gcfg.loop_min_peak_margin:
                continue
            # drift-relative plausibility bound: keyframe arc length since
            # the later of the matched keyframe and the last accept
            lo = max(int(a["i"]), self.last_accept_k)
            travel = 0.0
            if 0 <= lo < a["k_new"]:
                seg = np.stack(self.kf_poses[lo: a["k_new"] + 1])
                travel = float(
                    np.sum(np.hypot(np.diff(seg[:, 0]), np.diff(seg[:, 1])))
                )
            max_xy = max(
                self.gcfg.loop_max_correction_xy,
                self.gcfg.loop_correction_drift_xy * travel,
            )
            max_th = max(
                self.gcfg.loop_max_correction_theta,
                self.gcfg.loop_correction_drift_theta * travel,
            )
            if (
                np.hypot(corr[0], corr[1]) > max_xy
                or abs(corr[2]) > max_th
            ):
                continue
            attempt[6] = 1.0
            if self.defer_accept:
                self._accept_dispatch(
                    a["i"], a["k_new"],
                    np.asarray(matched_rel, np.float32), float(score),
                )
            else:
                est, nl_sync, Tc = self._accept(
                    a["i"], a["k_new"],
                    np.asarray(matched_rel, np.float32), float(score),
                    est, emitted_upto,
                )
                new_last_kf = nl_sync
                T_acc = Tc if T_acc is None else np.asarray(
                    _np_compose(Tc, T_acc), np.float32
                )
            accepted_k = a["k_new"]
            self.last_accept_k = a["k_new"]
            # sync-equivalent cooldown: keyframes admitted since the
            # accepted one already consumed part of it
            new_cooldown = max(
                0,
                self.gcfg.loop_cooldown
                - (len(self.kf_poses) - 1 - a["k_new"]),
            )
        for a in reissue:
            self.issue(a["k_new"], a["scan_i"])
        # queued issues go out unfiltered: the run loop's cooldown, adopted
        # at the accept's dispatch, already gated them
        for k, s in deferred_issues:
            self.issue(k, s)
        return new_cooldown, est, new_last_kf, T_acc

    def _dispatch_optimize(self, i, k_new, z, score):
        """Add the loop edge, copy the graph to the device and solve it.
        Returns tensors (poses[:n_now], chi2, pruned edge flags). The dense
        and sparse solvers solve again with the pruned edges masked (their
        only host read is the chi^2 prune's flags); the Schur solver, as
        the JAX package's, does not: the flags land in the HostGraph at the
        finalize, and the next solve leaves the edges out."""
        optimizer = self.optimizer
        if optimizer == "auto":
            optimizer = (
                "dense" if len(self.kf_poses) <= DENSE_MAX_KEYFRAMES
                else "hier"
            )
        _check_optimizer(optimizer)
        self.graph.add_edge(i, k_new, z, np.eye(3) * self.loop_edge_info)
        self.loop_records.append((i, k_new, score, z[0], z[1], z[2]))
        self.n_loops += 1
        with _accept_phase("accept/graph_to_device"):
            dev_graph = self.graph.to_device(self.device)
        with _accept_phase("accept/optimize+fetch"):
            return self._solve_and_prune(optimizer, dev_graph)

    def _solve_and_prune(self, optimizer, dev_graph):
        """The solve of `_dispatch_optimize` and the chi2 prune's
        re-solve; returns its (poses, chi2, pruned flags)."""
        gcfg = self.gcfg
        dev_graph, chi = self._solve(optimizer, dev_graph, self.graph)
        prune_chi2 = float(gcfg.loop_prune_chi2)
        if prune_chi2 > 0.0:
            # two detectors: a loop edge's own whitened residual^2 at the
            # solution above the threshold, or THIS accept raising the
            # converged total by more than it
            chis = se2_graph.edge_chi2s(dev_graph.poses, dev_graph)
            ei = dev_graph.edges_ij[:, 0]
            ej = dev_graph.edges_ij[:, 1]
            is_loop = (ej != ei + 1) & (ei != ej + 1) & dev_graph.edge_mask
            prune = is_loop & (chis > prune_chi2)
            delta_bad = (chi - float(np.float32(self.chi2))) > prune_chi2
            new_e = (
                torch.arange(chis.shape[0], device=chis.device)
                == self.graph.n_edges - 1
            )
            prune = prune | (new_e & delta_bad)
            # solve again from the solved iterate only when something was
            # pruned (with GNC a warm re-solve is not a no-op); never
            # under "schur"
            if optimizer not in ("schur", "schur_sharded"):
                # the flags in one read (the sparse solvers plan the
                # re-solve's topology from them on the host)
                pruned = fetch(prune)[0]
                if pruned.any():
                    host = copy.copy(self.graph)
                    host.edge_mask = self.graph.edge_mask & ~pruned
                    g2, chi = self._solve(
                        optimizer, dev_graph._replace(
                            edge_mask=dev_graph.edge_mask & ~prune), host)
                    dev_graph = dev_graph._replace(poses=g2.poses)
        else:
            prune = torch.zeros_like(dev_graph.edge_mask)
        return dev_graph.poses[: len(self.kf_poses)], chi, prune

    def _solve(self, optimizer, dev_graph, host):
        """One solve of `dev_graph` by `optimizer`, the Schur and the sparse
        solvers planned from `host` (the HostGraph, or a shallow copy of it
        with the solve's edge mask): no read of the device."""
        gcfg = self.gcfg
        if optimizer == "schur":
            return schur.optimize_schur(
                dev_graph, gcfg, SCHUR_BLOCKS,
                plan=schur.build_plan(host, SCHUR_BLOCKS))
        if optimizer == "schur_sharded":
            mesh = solve_mesh(self.mesh)
            if mesh is None:
                return schur.optimize_schur(
                    dev_graph, gcfg, 1, plan=schur.build_plan(host, 1))
            # no re-solve runs under "schur_sharded" (as under "schur"):
            # the graph solved is the HostGraph as rank 0 holds it
            host = agree_graph(host, mesh)
            if mesh.world_size > 1:
                dev_graph = host.to_device(self.device)
            n_blocks = mesh.world_size
            return schur.optimize_schur_sharded(
                dev_graph, gcfg, mesh, n_blocks,
                plan=schur.build_plan(host, n_blocks))
        if optimizer in ("sparse", "hier"):
            hier = optimizer == "hier"
            plan = sparse.sparse_plan(host, gcfg, self.device, hier=hier)
            solve = sparse.optimize_hier if hier else sparse.optimize_cg
            return solve(dev_graph, gcfg, plan=plan)
        return se2_graph.optimize(dev_graph, gcfg)

    def _accept_dispatch(self, i, k_new, z, score):
        """Deferred accept, first half: solve, and remember what the
        bookkeeping at the next chunk boundary needs."""
        assert self.pending_accept is None
        dev = self._dispatch_optimize(i, k_new, z, score)
        self.pending_accept = {
            "n0": len(self.kf_poses),   # keyframes covered by the solve
            "dev": dev,
            "new_edge_idx": self.graph.n_edges - 1,
        }

    def _apply_prune(self, pruned):
        """Disable the flagged loop edges in the HostGraph for good."""
        idx = np.nonzero(np.asarray(pruned))[0]
        if len(idx):
            self.graph.edge_mask[idx] = False
            self.n_pruned += len(idx)

    def _finalize_accept(self, est, emitted_upto):
        """Deferred accept, second half (one chunk after the dispatch): read
        the corrected poses, move keyframes admitted meanwhile rigidly with
        the last solved keyframe, and run the correction tail. Returns
        (est, last_kf_pose, Tc)."""
        pa = self.pending_accept
        self.pending_accept = None
        with _accept_phase("accept/optimize+fetch"):
            corrected0, chi_h, pruned = fetch(*pa["dev"])
        self._apply_prune(pruned)
        self.chi2 = float(chi_h)
        n0 = pa["n0"]
        nk = len(self.kf_poses)
        old_kf = np.stack(self.kf_poses)   # pre-correction for ALL k
        if pruned[pa["new_edge_idx"]]:
            # the accept itself was pruned: the re-solve already dropped
            # it; apply no correction
            corrected0 = old_kf[:n0].copy()
        Tc = np.asarray(
            _np_compose(corrected0[n0 - 1], _np_inverse(old_kf[n0 - 1])),
            np.float32,
        )
        if nk > n0:
            corrected = np.concatenate(
                [corrected0[:n0], _np_compose_batch(Tc, old_kf[n0:])]
            ).astype(np.float32)
        else:
            corrected = np.asarray(corrected0[:n0], np.float32)
        return self._apply_corrected(corrected, old_kf, est, emitted_upto)

    def _accept(self, i, k_new, z, score, est, emitted_upto):
        """Synchronous accept (defer_accept=False): solve, read, tail."""
        new_edge_idx = self.graph.n_edges  # the index add_edge will use
        dev = self._dispatch_optimize(i, k_new, z, score)
        with _accept_phase("accept/optimize+fetch"):
            corrected, chi_h, pruned = fetch(*dev)
        self._apply_prune(pruned)
        self.chi2 = float(chi_h)
        old_kf = np.stack(self.kf_poses)
        if pruned[new_edge_idx]:
            corrected = old_kf[: len(corrected)].copy()
        return self._apply_corrected(
            np.asarray(corrected, np.float32), old_kf, est, emitted_upto
        )

    def _apply_corrected(self, corrected, old_kf, est, emitted_upto):
        """The correction tail: graph and keyframe poses, submap-cache
        invalidation, trajectory retro-correction, the frontend pose's
        transport and run_full_slam's map rebuild. Returns (est,
        last_kf_pose, Tc)."""
        self.graph.set_poses(corrected)
        for k in range(len(self.kf_poses)):
            self.kf_poses[k] = corrected[k]
        self.cache_anchor = -1
        self.cache_gs = None
        with _accept_phase("accept/retro_correct_host"):
            _retro_correct_traj(
                self.traj_out, self.kf_scan_idx, old_kf, corrected,
                emitted_upto, offset=self.scan_index_offset,
            )
        # transport the motion since the LAST keyframe onto its corrected
        # pose, as a left transform Tc = corrected_last ∘ old_last^-1 that
        # run_full_slam applies to the device pose too
        Tc = np.asarray(
            _np_compose(self.kf_poses[-1], _np_inverse(old_kf[-1])),
            np.float32,
        )
        est = np.asarray(_np_compose(Tc, est), np.float32)
        self.apply_correction(Tc)
        return est, self.kf_poses[-1].copy(), Tc


def _owned(x, device, dtype=torch.float32):
    """A tensor on `device` that owns its memory, from a tensor or numpy."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype, copy=True)
    return torch.tensor(np.asarray(x), dtype=dtype, device=device)


class HostLoop:
    """The host side of a full-SLAM run, shared by run_full_slam and
    run_full_slam_tiled: the keyframe store and the pose graph (empty, or
    copied from a checkpoint's host fields), keyframe admission and loop
    attempts one chunk behind the tracking, the LoopCloser's resolve at
    each chunk boundary with the correction owed to the rows not yet
    processed, the final drain, the checkpoint's host fields and the
    result. The runner supplies the tracking and `apply_correction(Tc)`
    (the map rebuild and the frontend-state patch), sets `est` (and
    `base`, for the tiled forecast) from its initial state, and hands
    each chunk it has run to `step`: a dict of its first scan "s0", its
    length "n", its poses "tr" [K, 3] and final pose "pose" (tensors),
    and optionally "base" (its last odometry, kept as `base` when the
    chunk is processed) and "logodds" (a map copy for `frame_cb`)."""

    def __init__(self, cfg, graph_cfg, loop_matcher, submap_halfwidth,
                 ranges_np, optimizer, odom_edge_info, loop_edge_info,
                 scan_index_offset, apply_correction, resume=None,
                 defer_accept=True, frame_cb=None, device="cuda",
                 plain=False, mesh=None):
        self.gcfg = graph_cfg
        self.ranges_np = ranges_np
        self.offset = scan_index_offset
        self.odom_edge_info = odom_edge_info
        self.frame_cb = frame_cb
        n_loops, chi2, cache_anchor = 0, 0.0, -1
        self.graph = se2_graph.HostGraph(graph_cfg)
        self.kf_poses, self.kf_scans, self.kf_scan_idx = [], [], []
        self.loop_records = []
        self.cooldown = 0
        self.last_kf_pose = None
        if resume is not None:
            self.graph = se2_graph.HostGraph.from_arrays(graph_cfg,
                                                        resume["graph"])
            kc = int(resume["kf_count"])
            self.kf_poses = [np.array(resume["kf_poses"][k], np.float32)
                             for k in range(kc)]
            self.kf_scans = [np.array(resume["kf_scans"][k], np.float32)
                             for k in range(kc)]
            self.kf_scan_idx = [int(resume["kf_scan_idx"][k])
                                for k in range(kc)]
            n_loops = int(resume["n_loops"])
            self.loop_records = [tuple(np.asarray(resume["loops"][k]))
                                 for k in range(n_loops)]
            chi2 = float(resume["chi2"])
            self.cooldown = int(resume["cooldown"])
            if kc > 0:
                self.last_kf_pose = np.array(resume["last_kf_pose"],
                                             np.float32)
            cache_anchor = int(resume["loop_cache_anchor"])
        self.traj_out = np.zeros((len(ranges_np), 3), np.float32)
        self.closer = LoopCloser(
            cfg, graph_cfg, loop_matcher, default_submap_grid(cfg),
            submap_halfwidth, self.graph, self.kf_poses, self.kf_scans,
            self.kf_scan_idx, ranges_np, self.traj_out, optimizer,
            loop_edge_info, scan_index_offset, apply_correction,
            self.loop_records, n_loops=n_loops, chi2=chi2,
            cache_anchor=cache_anchor, defer_accept=defer_accept,
            device=device, plain=plain, mesh=mesh,
        )
        self.emitted_upto = -1   # last traj_out row written (run-local)
        self.est = None          # pose after the last processed chunk
        self.base = None         # its odometry (the tiled forecast's)
        self.pend = None         # run-but-unprocessed chunk outputs
        self.pend_T = None       # left transform owed to pend's rows

    def admit(self, pose, scan_i: int) -> int:
        """Admit a keyframe at run-local scan `scan_i`; returns its index."""
        self.kf_poses.append(pose.copy())
        self.kf_scans.append(self.ranges_np[scan_i])
        self.kf_scan_idx.append(scan_i + self.offset)  # absolute index
        self.graph.add_node(pose)
        k = len(self.kf_poses) - 1
        if k > 0:
            z = _np_between(self.kf_poses[k - 1], pose)
            self.graph.add_edge(k - 1, k, z, np.eye(3) * self.odom_edge_info)
        return k

    def process_pending(self):
        """Read the pending chunk's poses in one copy, owe them the
        corrections accepted since it ran, emit them, and admit its
        keyframes (issuing loop attempts outside the cooldown)."""
        pend = self.pend
        if pend is None:
            return
        tr, est_new = fetch(pend["tr"], pend["pose"])
        n_here = pend["n"]
        tr = tr[:n_here]
        self.est = np.asarray(est_new, np.float32)
        if "base" in pend:
            self.base = pend["base"]
        if self.pend_T is not None:
            tr = _np_compose_batch(self.pend_T, tr)
            self.est = np.asarray(_np_compose(self.pend_T, self.est),
                                  np.float32)
            self.pend_T = None
        s0 = pend["s0"]
        self.traj_out[s0 : s0 + n_here] = tr
        self.emitted_upto = s0 + n_here - 1
        if self.frame_cb is not None:
            self.frame_cb(pend["logodds"], tr)
        gcfg = self.gcfg
        for t in range(n_here):
            scan_i = s0 + t
            pose = tr[t]
            if self.last_kf_pose is None:
                self.last_kf_pose = pose
                self.admit(pose, scan_i)
                continue
            last = self.last_kf_pose
            moved = np.hypot(*(pose[:2] - last[:2]))
            rot = abs((pose[2] - last[2] + np.pi) % (2 * np.pi) - np.pi)
            if moved >= gcfg.keyframe_dist or rot >= gcfg.keyframe_angle:
                if len(self.kf_poses) >= gcfg.max_nodes - 1:
                    continue
                self.last_kf_pose = pose
                k_new = self.admit(pose, scan_i)
                if self.cooldown > 0:
                    self.cooldown -= 1
                else:
                    self.closer.issue(k_new, scan_i)
        self.pend = None

    def _resolve(self):
        cd, self.est, nl, T_acc = self.closer.resolve(self.est,
                                                      self.emitted_upto)
        if cd is not None:
            self.cooldown = cd
        if nl is not None:
            self.last_kf_pose = nl
        return T_acc

    def step(self, cand: dict):
        """A chunk has run (`cand`, captured before any accept patches the
        state): process the previous one, resolve the pending attempts,
        and owe this chunk the correction of every accept finalized
        here."""
        self.process_pending()
        T_acc = self._resolve()
        if T_acc is not None:
            self.pend_T = T_acc if self.pend_T is None else np.asarray(
                _np_compose(T_acc, self.pend_T), np.float32
            )
        self.pend = cand

    def finish(self):
        """Process the last chunk and drain: an accept can issue attempts
        again, and a deferred accept still needs its finalize."""
        self.process_pending()
        while self.closer.pending or self.closer.pending_accept is not None:
            self._resolve()

    def checkpoint(self, ckpt: dict, rebuilder, frontend, device) -> dict:
        """Fill `ckpt` (a template of the runner's schema) with the run's
        state: `frontend`, the graph, the keyframes, loops and counters,
        and `rebuilder`'s render poses."""
        closer = self.closer
        ckpt["frontend"] = frontend
        ckpt["graph"] = self.graph.to_device(device)
        nk = len(self.kf_poses)
        if nk:
            ckpt["kf_poses"][:nk] = np.stack(self.kf_poses)
            ckpt["kf_scans"][:nk] = np.stack(self.kf_scans)
            ckpt["kf_scan_idx"][:nk] = np.asarray(self.kf_scan_idx, np.int32)
            ckpt["last_kf_pose"] = np.asarray(
                self.last_kf_pose if self.last_kf_pose is not None
                else self.kf_poses[-1], np.float32,
            )
        ckpt["kf_count"] = np.int32(nk)
        if self.loop_records:
            ckpt["loops"][:closer.n_loops] = np.asarray(self.loop_records,
                                                        np.float32)
        ckpt["n_loops"] = np.int32(closer.n_loops)
        ckpt["chi2"] = np.float32(closer.chi2)
        ckpt["cooldown"] = np.int32(self.cooldown)
        ckpt["loop_cache_anchor"] = np.int32(closer.cache_anchor)
        ckpt["map_poses"] = rebuilder.map_poses.copy()
        ckpt["map_pose_count"] = np.int32(rebuilder.n_prev)
        return ckpt

    def result(self, grid, ckpt) -> FullSLAMResult:
        closer = self.closer
        return FullSLAMResult(
            traj=self.traj_out,
            kf_poses=(np.stack(self.kf_poses) if self.kf_poses
                      else np.zeros((0, 3))),
            kf_scan_idx=np.asarray(self.kf_scan_idx, np.int64),
            n_loops=closer.n_loops,
            grid=grid,
            chi2=closer.chi2,
            loops=np.asarray(self.loop_records, np.float32).reshape(-1, 6),
            loop_attempts=np.asarray(
                closer.attempt_records, np.float32
            ).reshape(-1, 10),
            ckpt=ckpt,
        )


def run_full_slam(
    log: dict,
    cfg: FrontendConfig,
    graph_cfg: GraphConfig,
    loop_matcher: MatcherConfig | None = None,
    submap_halfwidth: int = 3,
    odom_edge_info: float = 50.0,
    loop_edge_info: float = 200.0,
    optimizer: str = "auto",
    resume: dict | None = None,
    scan_index_offset: int = 0,
    incremental_rebuild: bool = True,
    frame_cb=None,
    defer_accept: bool = True,
    device="cuda",
    plain: bool = False,
    mesh=None,
):
    """Run full SLAM over a host-side log {odom, ranges} on `device`.
    Returns a FullSLAMResult.

    `frame_cb(logodds, traj_chunk)` is called once a chunk, one chunk
    behind the tracking as in the JAX package, with a copy of the map at
    that chunk's end and the chunk's poses (numpy [n, 3]).

    optimizer: "dense" (one Cholesky over all keyframes), "schur"
    (keyframe blocks eliminated, graph/schur.py, 4 blocks), "sparse"
    (matrix-free PCG, graph/sparse.py:optimize_cg), "hier" (the V-cycle,
    optimize_hier), "auto" (dense up to DENSE_MAX_KEYFRAMES keyframes,
    hier beyond) or "schur_sharded" (the blocks split over the ranks of
    `mesh`, one block a rank: graph/schur.py's optimize_schur_sharded;
    every rank runs this function on its own device, `device` the mesh's;
    `mesh` None takes the mesh this process joined, else solves as one
    rank would: optimize_schur with one block).

    resume: a previous run's `ckpt` (or numpy arrays of
    fullslam_ckpt_template's schema) to continue from, with
    scan_index_offset the number of scans that run consumed, so keyframe
    scan indices stay absolute. The resumed state is copied.
    `plain=True` runs every kernel's plain version (checks only).

    Plain integers on `run_full_slam` count the loop attempts scored
    (`attempts`: two scorer passes and a peak margin each), the submaps
    built for them (`submaps`, `submap_scans` integrated), the keyframe
    scans integrated by map rebuilds (`rebuilt_scans`) and the accepted
    corrections applied (`corrections`: a rebuild and a whole-map search
    space each); a caller may reset them."""
    _check_optimizer(optimizer)
    odom_np = np.asarray(log["odom"], np.float32)
    ranges_np = np.asarray(log["ranges"], np.float32)
    T = len(odom_np)
    K = cfg.chunk

    rebuild = IncrementalRebuilder(
        cfg, graph_cfg.max_nodes,
        # eps 0: nothing snaps, every rebuild replays from empty
        eps_cells=0.25 if incremental_rebuild else 0.0,
        device=device, plain=plain,
    )
    if resume is not None:
        state = FrontendState(*(_owned(x, device) for x in resume["frontend"]))
        rebuild.restore(resume["map_poses"], resume["map_pose_count"])
    else:
        state = frontend_init(cfg, device, start_pose=odom_np[0],
                              start_odom=odom_np[0], plain=plain)

    def apply_correction(corr_np):
        # rebuild the map from every (corrected) keyframe and patch the
        # live frontend; `corr_np` is the LEFT correction transform, valid
        # on the device pose even when it has run a chunk past `est`
        nonlocal state
        run_full_slam.corrections += 1
        Tc = torch.as_tensor(corr_np, dtype=torch.float32, device=device)
        Kmax = graph_cfg.max_nodes
        poses_buf = np.zeros((Kmax, 3), np.float32)
        scans_buf = np.zeros((Kmax, ranges_np.shape[1]), np.float32)
        mask_buf = np.zeros(Kmax, np.float32)
        nk = len(host.kf_poses)
        poses_buf[:nk] = np.stack(host.kf_poses)
        scans_buf[:nk] = np.stack(host.kf_scans)
        mask_buf[:nk] = 1.0
        new_grid = rebuild(poses_buf, scans_buf, mask_buf, n_active=nk)
        new_pose = se2.compose(Tc, state.pose)
        state = state._replace(
            logodds=new_grid,
            search_space=build_search_space(
                new_grid, cfg.matcher, cfg.grid.resolution, plain=plain
            ),
            pose=new_pose,
            last_map_pose=new_pose.clone(),
        )

    host = HostLoop(
        cfg, graph_cfg, loop_matcher or default_loop_matcher(graph_cfg),
        submap_halfwidth, ranges_np, optimizer, odom_edge_info,
        loop_edge_info, scan_index_offset, apply_correction, resume,
        defer_accept, frame_cb, device, plain, mesh=mesh,
    )
    (host.est,) = fetch(state.pose)
    # the host loop over chunks: run chunk c, then process chunk c-1 and
    # resolve the pending attempts (HostLoop.step)
    odom_p, ranges_p = _pad_log(odom_np, ranges_np, K)
    for s0 in range(0, T, K):
        out = torch.empty((K, 4), dtype=torch.float32, device=device)
        state = run_chunk(state, odom_p[s0 : s0 + K],
                          ranges_p[s0 : s0 + K], cfg, out, plain)
        # the map is copied, since the next chunk writes into it
        host.step({
            "s0": s0, "n": min(K, T - s0), "tr": out[:, :3],
            "pose": state.pose,
            "logodds": state.logodds.clone() if frame_cb is not None else None,
        })
    host.finish()
    ckpt = host.checkpoint(
        fullslam_ckpt_template(cfg, graph_cfg), rebuild,
        FrontendState(*(t.clone() for t in state)), device,
    )
    return host.result(state.logodds, ckpt)


run_full_slam.attempts = 0
run_full_slam.submaps = 0
run_full_slam.submap_scans = 0
run_full_slam.rebuilt_scans = 0
run_full_slam.corrections = 0
