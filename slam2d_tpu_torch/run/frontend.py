"""Scan-matching SLAM frontend driver, port of slam2d_tpu/run/frontend.py.

Per scan: prior = pose ⊕ odometry delta; a motion-gated correlative match
against the cached search space inside a scan window; a motion-gated
log-odds update of an update window, whose search-space window is then
rebuilt and written back. In localization mode (`run_localization`,
cfg.localize_only) the map is fixed: no bootstrap and no update.

The gates stay on the device, as the JAX package's `lax.cond`s do: the
window origins are clamped there, the match's result is selected against
the prior with `torch.where`, and the update's kernels (kernel 1 `hybrid`
in place, kernel 3 on the kept cells) and the scorer (kernel 2) read the
gate and the origin from device memory and return at once on a gate of
0, which leaves the map and its search space bit-identical. Every
update_impl has that form (grid/occupancy.py:integrate_scan_window):
kernel 1 `ray` and `ism` read their gate and window origin as `hybrid`
does, the sampled-ray update adds its entries in place (-0.0 on a gate
of 0) and the dense one selects its window with the gate. On CUDA a
whole chunk of scans is one CUDA graph (`ChunkGraph`), replayed once a
chunk: the host reads nothing a scan. On the CPU the step branches on
the gate's value instead (a CPU read drains no stream); both forms give
the same bits (tests/test_torch_device_gates.py).

`frontend_step` counts the host reads of CUDA tensors (`host_syncs`, a
plain integer) and, on the device, the scans that were matched
(`matches`) and integrated (`updates`): reading either attribute reads
the device counters back once and gives an integer; a caller may set
them (to 0).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from slam2d_tpu_torch.config import FrontendConfig
from slam2d_tpu_torch.core import se2
from slam2d_tpu_torch.grid.occupancy import (
    integrate_scan_window,
    make_grid,
    world_to_cell,
)
from slam2d_tpu_torch.grid.window import (
    blur_halo_cells,
    scan_window_cells,
    take_window,
    update_window_cells,
    window_origin_t,
    window_origin_xy_t,
)
from slam2d_tpu_torch.match.correlative import (
    build_search_space,
    gaussian_kernel_1d,
    match_scan,
)
from slam2d_tpu_torch.ops.corr import corr_scores
from slam2d_tpu_torch.ops.score import score_window
from slam2d_tpu_torch.ops.search_space import search_space, search_space_window
from slam2d_tpu_torch.ops.update import update_hybrid, update_ism, update_ray
from slam2d_tpu_torch.run.capture import (
    ChunkCapture,
    chunk_graph_of,
    cuda_device,
    pinned,
    use_graph,
)
from slam2d_tpu_torch.utils import profiling

# the kernels a frontend step can launch (corr_scores: the match under
# score_impl "cmx" / "emx"), whose counts a chunk graph corrects
FRONTEND_KERNELS = (update_hybrid, update_ray, update_ism, search_space,
                    score_window, corr_scores)


class FrontendState(NamedTuple):
    logodds: torch.Tensor        # [H, W]
    search_space: torch.Tensor   # [H, W] cached blurred likelihood field
    pose: torch.Tensor           # [3] current corrected pose estimate
    prev_odom: torch.Tensor      # [3] odometry pose at the previous scan
    dist: torch.Tensor           # scalar: cumulative distance traveled
    last_map_pose: torch.Tensor  # [3] pose at the last map integration
    since_match: torch.Tensor    # [2] (translation, rotation) since last match


def frontend_init(
    cfg: FrontendConfig, device="cuda", start_pose=None, start_odom=None,
    plain: bool = False,
):
    """Fresh state on `device`: an empty map and its search space."""
    f32 = dict(dtype=torch.float32, device=device)
    pose = (
        torch.zeros(3, **f32) if start_pose is None
        else torch.as_tensor(np.asarray(start_pose, np.float32), device=device)
    )
    odom = (
        pose.clone() if start_odom is None
        else torch.as_tensor(np.asarray(start_odom, np.float32), device=device)
    )
    grid = make_grid(cfg.grid, device)
    return FrontendState(
        grid,
        build_search_space(grid, cfg.matcher, cfg.grid.resolution, plain=plain),
        pose, odom.clone(), torch.zeros((), **f32), pose.clone(),
        torch.zeros(2, **f32),
    )


class FrontendStep:
    """`frontend_step`: one scan, with its counters (see the module doc)."""

    def __init__(self):
        self.host_syncs = 0
        self._ints = {"matches": 0, "updates": 0}
        self._pending = {}   # device -> int64 [2] (matches, updates)

    def __call__(self, state, odom, ranges, cfg, plain=False,
                 host_branch=None, counts=None):
        return _step(state, odom, ranges, cfg, plain, host_branch, counts)

    def counter(self, device) -> torch.Tensor:
        """The device's [2] (matches, updates) accumulator that steps given
        no `counts` add to (made on first use: outside a graph capture)."""
        key = torch.device(device)
        if key not in self._pending:
            self._pending[key] = torch.zeros(2, dtype=torch.int64, device=key)
        return self._pending[key]

    def _flush(self):
        for acc in self._pending.values():
            m, u = acc.cpu().tolist()
            acc.zero_()
            self._ints["matches"] += m
            self._ints["updates"] += u

    def _get(name):
        def get(self):
            self._flush()
            return self._ints[name]

        def set_(self, value):
            self._flush()
            self._ints[name] = int(value)

        return property(get, set_)

    matches = _get("matches")
    updates = _get("updates")
    del _get


def read_host(t) -> torch.Tensor:
    """`t` on the host; a read of a CUDA tensor counts in
    frontend_step.host_syncs (a CPU read drains no stream)."""
    if t.is_cuda:
        frontend_step.host_syncs += 1
    return t.cpu()


def _match(state, ranges, prior, since_m, do_match, cfg, plain, run):
    """(pose, score, since_m) of the gated match: the prior, -1 and
    since_m where the gate is false, since_m zeroed where it is true.
    `run` False (the CPU, gate false) skips the work."""
    gcfg = cfg.grid
    if not run:
        return prior, torch.full_like(prior[0], -1.0), since_m
    win = scan_window_cells(gcfg, cfg.sensor, cfg.matcher)
    if win < min(gcfg.height, gcfg.width):
        origin = window_origin_t(world_to_cell(prior[:2], gcfg), win,
                                 gcfg.height, gcfg.width)
        S = take_window(state.search_space, origin, (win, win))
        origin_xy = window_origin_xy_t(gcfg.origin_x, gcfg.origin_y,
                                       gcfg.resolution, origin)
    else:
        S, origin_xy = state.search_space, None
    pose, score = match_scan(
        state.logodds, ranges, prior, gcfg, cfg.matcher, cfg.sensor,
        search_space=S, origin_xy=origin_xy, plain=plain, gate=do_match,
    )
    return (torch.where(do_match, pose, prior),
            torch.where(do_match, score, -1.0),
            torch.where(do_match, 0.0, since_m))


def _update(state, ranges, pose, do_update, cfg, plain, run):
    """The gated map update and search-space rebuild, in place (the
    update_impl's window form and kernel 3, with the gate and the window
    origin on the device).
    `run` False (the CPU, gate false) skips the work."""
    if not run:
        return
    gcfg, mcfg = cfg.grid, cfg.matcher
    H, W = gcfg.height, gcfg.width
    uwin = update_window_cells(gcfg, cfg.sensor, mcfg)
    if uwin < min(H, W):
        origin = window_origin_t(world_to_cell(pose[:2], gcfg), uwin, H, W)
        size, margin = (uwin, uwin), blur_halo_cells(mcfg, gcfg.resolution)
    else:
        origin, size, margin = None, (H, W), 0
    integrate_scan_window(state.logodds, pose, ranges, gcfg, cfg.sensor,
                          origin=origin, size=size, gate=do_update,
                          plain=plain)
    taps = gaussian_kernel_1d(mcfg.sigma_m / gcfg.resolution,
                              blur_halo_cells(mcfg, gcfg.resolution))
    search_space_window(
        state.logodds, state.search_space, taps, origin=origin, size=size,
        margin=margin, gate=do_update, occ_sat=mcfg.occ_evidence_sat,
        free_threshold=mcfg.free_threshold, free_penalty=mcfg.free_penalty,
        plain=plain,
    )


def _step(state: FrontendState, odom, ranges, cfg: FrontendConfig,
          plain: bool = False, host_branch=None, counts=None):
    """One scan: odometry prior -> gated correlative match -> gated map update.

    `odom` [3] and `ranges` [B] are float32 tensors on the state's device.
    Returns (state, (pose [3], score)). The map tensors of `state` are
    updated in place. `plain=True` runs every kernel's plain PyTorch
    version even on a CUDA device (for checks). Bootstrap (first
    `bootstrap_dist` meters) trusts the odometry prior and integrates
    every scan; afterwards the matcher and the map update each run only
    after enough motion (see FrontendConfig). With cfg.localize_only the
    map is given: there is no bootstrap, and the step returns after the
    match with the map, its search space and last_map_pose untouched.

    The gates are device tensors (see the module doc). `host_branch`
    (default: on the CPU) reads each gate and skips the gated-off work,
    with the same bits. `counts` (an int64 [2] device tensor; default:
    the step's own accumulator for the device) gets the gates added.
    """
    gcfg = cfg.grid
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
    do_match = (
        (since_m[0] >= cfg.match_min_motion) | (since_m[1] >= cfg.match_min_rot)
    )
    if not cfg.localize_only:
        do_match = do_match & ~in_boot
    pose, score, since_m = _match(
        state, ranges, prior, since_m, do_match, cfg, plain,
        run=not host_branch or bool(do_match),
    )
    dist = state.dist + step_len
    if counts is None:
        counts = frontend_step.counter(dev)
    if cfg.localize_only:
        counts += torch.stack([do_match, torch.zeros_like(do_match)])
        return (
            FrontendState(
                state.logodds, state.search_space, pose, odom, dist,
                state.last_map_pose, since_m,
            ),
            (pose, score),
        )

    moved = torch.hypot(
        pose[0] - state.last_map_pose[0], pose[1] - state.last_map_pose[1]
    )
    rotated = torch.abs(se2.wrap_angle(pose[2] - state.last_map_pose[2]))
    do_update = in_boot | (moved >= cfg.map_update_min_motion) | (
        rotated >= cfg.map_update_min_rot
    )
    counts += torch.stack([do_match, do_update])
    _update(state, ranges, pose, do_update, cfg, plain,
            run=not host_branch or bool(do_update))
    last_map_pose = torch.where(do_update, pose, state.last_map_pose)
    return (
        FrontendState(
            state.logodds, state.search_space, pose, odom, dist,
            last_map_pose, since_m,
        ),
        (pose, score),
    )


frontend_step = FrontendStep()
frontend_step.__doc__ = _step.__doc__


class ChunkGraph(ChunkCapture):
    """K frontend steps of one config on one CUDA device, captured as one
    CUDA graph on static buffers: the seven FrontendState fields, odometry
    [K, 3], ranges [K, B], the outputs [K, 4] (pose, score) and the
    (matches, updates) counters. Built once per (cfg, device, K)
    (`chunk_graph`) by run/capture.py's ChunkCapture: warm-up steps on a
    side stream, then the K steps captured.

    Per chunk (the module's `run_chunk`): the state copied into the
    static buffers (`load`), one copy of odometry and ranges from pinned
    host memory into them, one replay, one device copy of the outputs,
    the new state cloned out (`finish`). Nothing is read back to the
    host. The kernels' launch counters count a capture's launches once a
    replay. A failed build or capture raises; nothing falls back to the
    eager loop."""

    step = frontend_step

    def __init__(self, cfg: FrontendConfig, device, K: int):
        device = cuda_device(device)
        self.cfg, self.device, self.K = cfg, device, K
        H, W, B = cfg.grid.height, cfg.grid.width, cfg.sensor.n_beams
        f32 = dict(dtype=torch.float32, device=device)
        self.state = FrontendState(
            torch.zeros((H, W), **f32), torch.zeros((H, W), **f32),
            torch.zeros(3, **f32), torch.zeros(3, **f32),
            torch.zeros((), **f32), torch.zeros(3, **f32),
            torch.zeros(2, **f32),
        )
        self.inputs = (torch.zeros((K, 3), **f32), torch.zeros((K, B), **f32))
        self.out = torch.zeros((K, 4), **f32)
        self.counts = torch.zeros(2, dtype=torch.int64, device=device)
        self._capture(FRONTEND_KERNELS)

    def _one(self, k, state):
        """Step k of the chunk from `state`, its outputs into out[k]."""
        odom, ranges = self.inputs
        state, (pose, score) = _step(
            state, odom[k], ranges[k], self.cfg,
            host_branch=False, counts=self.counts,
        )
        self.out[k, :3] = pose
        self.out[k, 3] = score
        return state


def chunk_graph(cfg: FrontendConfig, device, K: int) -> ChunkGraph:
    """The cached ChunkGraph of (cfg, device, K), built on first use."""
    return chunk_graph_of(ChunkGraph, cfg, torch.device(device), K)


def _pad_log(odom: np.ndarray, ranges: np.ndarray, K: int):
    """(odom, ranges) with the tail padded to a multiple of K by repeating
    the last record, exactly as the JAX driver does (the padded scans run
    and change the final state)."""
    pad = -len(odom) % K
    if pad:
        odom = np.concatenate([odom, np.repeat(odom[-1:], pad, axis=0)])
        ranges = np.concatenate([ranges, np.repeat(ranges[-1:], pad, axis=0)])
    return odom, ranges


def run_chunk(state, odom, ranges, cfg: FrontendConfig, out,
              plain: bool = False, graph: bool | None = None
              ) -> FrontendState:
    """One chunk of scans from `state` (host arrays odom [K, 3], ranges
    [K, B]), each pose and score into `out` [K, 4] on the device. On CUDA
    (unless `plain` or `graph=False`) one replay of the config's
    ChunkGraph: the state copied into
    its buffers and the new state cloned out of them (a later chunk or
    run reuses the buffers), nothing read back. Else the steps one by one
    (the state's map tensors updated in place). Returns the new state."""
    device = out.device
    if not use_graph(device, plain, graph):
        with profiling.span("chunk.eager", scans=len(odom)):
            o = torch.as_tensor(odom, device=device)
            r = torch.as_tensor(ranges, device=device)
            for k in range(len(odom)):
                state, (pose, score) = frontend_step(state, o[k], r[k], cfg,
                                                     plain=plain)
                out[k, :3] = pose
                out[k, 3] = score
        return state
    g = chunk_graph(cfg, device, len(odom))
    odom, ranges = pinned(odom), pinned(ranges)
    g.load(state)
    g.run_chunk(odom, ranges, out)
    return g.finish()


def run_frontend(
    log: dict, cfg: FrontendConfig, device="cuda",
    state: FrontendState | None = None,
    plain: bool = False,
    frame_cb=None,
    graph: bool | None = None,
):
    """Run the frontend over a host-side log dict {odom, ranges} on `device`.

    The tail chunk is padded by repeating the last record and the outputs
    are truncated. On CUDA each chunk of cfg.chunk scans is one replay of
    the config's CUDA graph (`ChunkGraph`): the host reads nothing until
    the trajectory's one fetch at the end. `graph=False` runs the same
    device-gated steps eagerly instead (the CPU and `plain=True`, which
    runs every kernel's plain version for checks, always do). Each chunk
    is `run_chunk`: a given `state` is copied into the graph's buffers
    (eagerly: its maps updated in place); the returned state is the
    run's own.

    `frame_cb(logodds, traj_chunk)` is called at every chunk boundary (for
    animation capture), with the state's map tensor (the eager loop
    updates it in place later: copy it to keep it) and the chunk's real
    poses as a numpy [n, 3] array: one host read a chunk, so leave it
    None on throughput runs.

    Returns (final_state, traj [T, 3] np.ndarray, scores [T] np.ndarray),
    both fetched from the device in one copy.
    """
    with profiling.call(state is None):
        odom = np.asarray(log["odom"], np.float32)
        ranges = np.asarray(log["ranges"], np.float32)
        T = len(odom)
        K = cfg.chunk
        if state is None:
            with profiling.span("session.init"):
                state = frontend_init(cfg, device, start_pose=odom[0],
                                      start_odom=odom[0], plain=plain)
        with profiling.span("call.stage"):
            odom, ranges = _pad_log(odom, ranges, K)
            # [n_pad, 4]: the pose and the score of each scan
            out = torch.empty((len(odom), 4), dtype=torch.float32,
                              device=device)
            if use_graph(device, plain, graph):
                odom, ranges = pinned(odom), pinned(ranges)
        for s in range(0, len(odom), K):
            state = run_chunk(state, odom[s : s + K], ranges[s : s + K], cfg,
                              out[s : s + K], plain, graph)
            if frame_cb is not None:
                frame_cb(state.logodds,
                         out[s : min(s + K, T), :3].cpu().numpy())
        out = out[:T].cpu().numpy()
    return state, out[:, :3].copy(), out[:, 3].copy()


def run_frontend_offline(
    log: dict, cfg: FrontendConfig, device="cuda",
    state: FrontendState | None = None, graph: bool | None = None,
):
    """Whole-log frontend (offline mapping), with the JAX package's
    semantics: the tail padded to a multiple of cfg.chunk by repeating
    the last record, the chunks replayed (on CUDA, one CUDA graph replay
    a chunk) with no host read between them, one fetch of the trajectory,
    the outputs truncated; bit-identical to `run_frontend`.

    Returns (final_state, traj [T, 3] np.ndarray, scores [T] np.ndarray).
    """
    odom = np.asarray(log["odom"], np.float32)
    ranges = np.asarray(log["ranges"], np.float32)
    T = len(odom)
    odom, ranges = _pad_log(odom, ranges, cfg.chunk)
    state, traj, scores = run_frontend(
        {"odom": odom, "ranges": ranges}, cfg, device, state=state,
        graph=graph,
    )
    return state, traj[:T], scores[:T]


def localization_init(cfg: FrontendConfig, logodds, odom0, device="cuda",
                      start_pose=None, plain: bool = False):
    """(cfg with localize_only set, state) for tracking on the fixed map
    `logodds` ([H, W] numpy or a tensor of cfg.grid's geometry, copied to
    `device`): its search space built once (one kernel 3 launch), the pose
    `start_pose` (default: the first odometry pose `odom0`)."""
    cfg = dataclasses.replace(cfg, localize_only=True)
    if isinstance(logodds, torch.Tensor):
        grid = logodds.to(device=device, dtype=torch.float32, copy=True)
    else:
        grid = torch.tensor(np.asarray(logodds, np.float32), device=device)
    grid = grid.contiguous()
    if tuple(grid.shape) != (cfg.grid.height, cfg.grid.width):
        raise ValueError(
            f"map of shape {tuple(grid.shape)}, the grid is "
            f"{(cfg.grid.height, cfg.grid.width)}"
        )
    S = build_search_space(grid, cfg.matcher, cfg.grid.resolution, plain=plain)
    pose = torch.tensor(
        np.asarray(odom0 if start_pose is None else start_pose, np.float32),
        device=device,
    )
    # built directly: frontend_init would blur an empty grid for nothing
    return cfg, FrontendState(
        grid, S, pose, torch.tensor(np.asarray(odom0, np.float32),
                                    device=device),
        torch.zeros((), dtype=torch.float32, device=device), pose.clone(),
        torch.zeros(2, dtype=torch.float32, device=device),
    )


def run_localization(
    log: dict, cfg: FrontendConfig, logodds, device="cuda", start_pose=None,
    recover: bool = False, recover_score: float = 0.25,
    recover_accept: float = 0.5, recover_margin: float = 0.0,
    recover_consistent: bool = True, plain: bool = False,
    graph: bool | None = None,
):
    """Pose tracking against a FIXED prebuilt map (no bootstrap, no map
    updates): the AMCL-style localization mode. `logodds` is an [H, W]
    log-odds map (numpy or a tensor) of cfg.grid's geometry, e.g. a
    previous run's final map; it is copied, so the caller's map comes back
    unchanged. The search space is built once, on the whole map, and the
    scans run through `run_frontend`'s chunks with cfg.localize_only set:
    on CUDA one CUDA graph replay a chunk and no host read a scan
    (`graph` as for run_frontend). `start_pose` defaults to the first
    odometry pose. `plain=True` runs every kernel's plain version (checks
    only).

    With recover=True, a chunk whose matched scores collapse (at least 3
    matched scans, median below `recover_score`; skipped scans score
    exactly -1.0) triggers whole-map FFT relocalization
    (match/global_loc.py) on the chunk's last scan. A candidate commits
    when it scores >= recover_accept, clears the peak-uniqueness margin
    `recover_margin` (0 disables) and, with recover_consistent, agrees
    within 1 m / 0.5 rad with the previous lost chunk's candidate
    transported by the odometry between them; a healthy chunk expires the
    pending candidate. Recovery reads the chunk's scores once a chunk
    (one host read), and a relocalization's pose, score and margin once
    more.

    Returns (final_state, traj [T, 3], scores [T], events): events lists
    the accepted recoveries as {"scan", "score", "margin", "pose"} dicts,
    rounded to 4 digits as the JAX package rounds them ([] without
    recover)."""
    odom = np.asarray(log["odom"], np.float32)
    cfg, state = localization_init(cfg, logodds, odom[0], device,
                                   start_pose=start_pose, plain=plain)
    if not recover:
        state, traj, scores = run_frontend(log, cfg, device, state=state,
                                           plain=plain, graph=graph)
        return state, traj, scores, []

    from slam2d_tpu_torch.match.global_loc import global_localize
    from slam2d_tpu_torch.run.frontend_tiled import _np_between, _np_compose

    ranges = np.asarray(log["ranges"], np.float32)
    T = len(odom)
    K = cfg.chunk
    odom_p, ranges_p = _pad_log(odom, ranges, K)
    out = torch.empty((len(odom_p), 4), dtype=torch.float32, device=device)
    events: list = []
    cand = None          # (pose_np, scan_index) from the previous trigger
    for s in range(0, len(odom_p), K):
        state = run_chunk(state, odom_p[s : s + K], ranges_p[s : s + K], cfg,
                          out[s : s + K], plain, graph)
        n_here = min(K, T - s)
        sc_h = read_host(out[s : s + n_here, 3]).numpy()
        # skipped (no-motion) scans return EXACTLY -1.0; matched scans can
        # score negative too, and those are the collapsed matches to detect
        matched = sc_h[sc_h != -1.0]
        if not (len(matched) >= 3
                and float(np.median(matched)) < recover_score):
            # healthy chunk: consistency only ever compares CONSECUTIVE
            # lost chunks
            cand = None
            continue
        last = s + n_here - 1
        pose0, s0, m0 = global_localize(
            state.logodds, torch.as_tensor(ranges_p[last], device=device),
            cfg.grid, cfg.matcher, cfg.sensor,
            search_space=state.search_space, return_margin=True, plain=plain,
        )
        got = read_host(torch.cat([pose0, s0.reshape(1), m0.reshape(1)]))
        got = got.numpy()
        pose0, s0, m0 = got[:3], float(got[3]), float(got[4])
        gated = s0 >= recover_accept and m0 >= recover_margin
        agreed = not recover_consistent
        if gated and recover_consistent and cand is not None:
            # transport the previous candidate by the odometry between the
            # two trigger scans and compare
            dprev = _np_between(odom[cand[1]], odom[last])
            expect = _np_compose(cand[0], dprev)
            dd = _np_between(expect, pose0)
            agreed = (
                float(np.hypot(dd[0], dd[1])) <= 1.0
                and abs(float(dd[2])) <= 0.5
            )
        if gated and agreed:
            state = state._replace(pose=torch.as_tensor(pose0, device=device))
            events.append({
                "scan": last, "score": round(s0, 4), "margin": round(m0, 4),
                "pose": [round(float(v), 4) for v in pose0],
            })
            cand = None
        else:
            cand = (pose0, last) if gated else None
    out = out[:T].cpu().numpy()
    return state, out[:, :3].copy(), out[:, 3].copy(), events


def state_from_numpy(arrays, device) -> FrontendState:
    """FrontendState on `device` from its fields as numpy arrays, in field
    order — e.g. `[np.asarray(x) for x in jax_state]` of a JAX
    FrontendState, whose fields are the same."""
    return FrontendState(
        *(
            torch.as_tensor(np.array(a, np.float32), device=device)
            for a in arrays
        )
    )


def state_to_numpy(state: FrontendState) -> FrontendState:
    """The state's fields as numpy float32 arrays (a FrontendState)."""
    return FrontendState(*(t.cpu().numpy() for t in state))
