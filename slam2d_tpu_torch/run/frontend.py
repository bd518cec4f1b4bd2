"""Scan-matching SLAM frontend driver, port of slam2d_tpu/run/frontend.py.

Per scan: prior = pose ⊕ odometry delta; a motion-gated correlative match
against the cached search space inside a scan window; a motion-gated
log-odds update of an update window, whose search-space window is then
rebuilt and written back. In localization mode (`run_localization`,
cfg.localize_only) the map is fixed: no bootstrap and no update.

The two gates are read on the host: each is one small device-to-host read
per scan that also brings back the integer window center, so a window
costs no second read (localization has the match gate alone). The
trajectory stays on the device until the end of `run_frontend`. Plain
integers on `frontend_step` count the host reads (`host_syncs`) and the
scans that were matched (`matches`) and integrated (`updates`); a caller
may reset them.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from slam2d_tpu_torch.config import FrontendConfig
from slam2d_tpu_torch.core import se2
from slam2d_tpu_torch.grid.occupancy import (
    integrate_scan,
    make_grid,
    window_origin_xy,
    world_to_cell,
)
from slam2d_tpu_torch.grid.window import (
    blur_halo_cells,
    extract_window,
    scan_window_cells,
    update_window_cells,
    write_window,
    write_window_blur_exact,
)
from slam2d_tpu_torch.match.correlative import build_search_space, match_scan


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


def read_gate(gate, center_rc=None, owner=None):
    """One device-to-host read of a gate (and a window center with it),
    counted in `owner.host_syncs` (frontend_step's by default)."""
    (frontend_step if owner is None else owner).host_syncs += 1
    if center_rc is None:
        return bool(gate), None
    # one copy to the host: tolist() of a CUDA tensor copies per element
    packed = torch.cat([gate.reshape(1).to(torch.int32), center_rc]).cpu()
    g, r, c = packed.tolist()
    return bool(g), (r, c)


def frontend_step(
    state: FrontendState, odom, ranges, cfg: FrontendConfig,
    plain: bool = False,
):
    """One scan: odometry prior -> gated correlative match -> gated map update.

    `odom` [3] and `ranges` [B] are float32 tensors on the state's device.
    Returns (state, (pose [3], score)). The map tensors of `state` are
    updated in place when the scan is integrated. `plain=True` runs every
    kernel's plain PyTorch version even on a CUDA device (for checks).
    Bootstrap (first `bootstrap_dist` meters) trusts the odometry prior
    and integrates every scan; afterwards the matcher and the map update
    each run only after enough motion (see FrontendConfig). With
    cfg.localize_only the map is given: there is no bootstrap, and the
    step returns after the match with the map, its search space and
    last_map_pose untouched.
    """
    gcfg = cfg.grid
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

    win = scan_window_cells(gcfg, cfg.sensor, cfg.matcher)
    windowed = win < min(gcfg.height, gcfg.width)
    uwin = update_window_cells(gcfg, cfg.sensor, cfg.matcher)
    uwindowed = uwin < min(gcfg.height, gcfg.width)

    match, center = read_gate(
        do_match, world_to_cell(prior[:2], gcfg) if windowed else None
    )
    frontend_step.matches += match
    if not match:
        pose = prior
        score = torch.full((), -1.0, dtype=torch.float32, device=odom.device)
    elif not windowed:
        pose, score = match_scan(
            state.logodds, ranges, prior, gcfg, cfg.matcher, cfg.sensor,
            search_space=state.search_space, plain=plain,
        )
        since_m = torch.zeros_like(since_m)
    else:
        Sw, origin_rc = extract_window(state.search_space, center, win)
        pose, score = match_scan(
            state.logodds, ranges, prior, gcfg, cfg.matcher, cfg.sensor,
            search_space=Sw, origin_xy=window_origin_xy(gcfg, origin_rc),
            plain=plain,
        )
        since_m = torch.zeros_like(since_m)
    dist = state.dist + step_len
    if cfg.localize_only:
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
    update, center = read_gate(
        do_update, world_to_cell(pose[:2], gcfg) if uwindowed else None
    )
    logodds, search_space = state.logodds, state.search_space
    last_map_pose = state.last_map_pose
    frontend_step.updates += update
    if update:
        last_map_pose = pose
        if not uwindowed:
            logodds = integrate_scan(
                logodds, pose, ranges, gcfg, cfg.sensor, plain=plain
            )
            search_space = build_search_space(
                logodds, cfg.matcher, gcfg.resolution, plain=plain
            )
        else:
            gw, origin_rc = extract_window(logodds, center, uwin)
            gw = integrate_scan(
                gw, pose, ranges, gcfg, cfg.sensor, origin_rc=origin_rc,
                plain=plain,
            )
            write_window(logodds, gw, origin_rc)
            # rebuild the field on the window; its outer blur-halo ring
            # saw a truncated neighbourhood and is trimmed, except where
            # the window is clamped against the grid border
            Sw = build_search_space(
                gw, cfg.matcher, gcfg.resolution, plain=plain
            )
            halo = blur_halo_cells(cfg.matcher, gcfg.resolution)
            write_window_blur_exact(search_space, Sw, origin_rc, halo)
    return (
        FrontendState(
            logodds, search_space, pose, odom, dist, last_map_pose, since_m
        ),
        (pose, score),
    )


frontend_step.host_syncs = 0
frontend_step.matches = 0
frontend_step.updates = 0


def _run_chunk(state, odom, ranges, cfg, out, plain):
    """Step the scans of one chunk (host arrays odom [K, 3], ranges [K, B],
    copied to the device at once), writing each pose and score into the
    rows of `out` [K, 4]. Returns (state, the chunk's ranges tensor)."""
    o = torch.as_tensor(odom, device=out.device)
    r = torch.as_tensor(ranges, device=out.device)
    for k in range(len(odom)):
        state, (pose, score) = frontend_step(state, o[k], r[k], cfg,
                                             plain=plain)
        out[k, :3] = pose
        out[k, 3] = score
    return state, r


def _pad_log(odom: np.ndarray, ranges: np.ndarray, K: int):
    """(odom, ranges) with the tail padded to a multiple of K by repeating
    the last record, exactly as the JAX driver does (the padded scans run
    and change the final state)."""
    pad = -len(odom) % K
    if pad:
        odom = np.concatenate([odom, np.repeat(odom[-1:], pad, axis=0)])
        ranges = np.concatenate([ranges, np.repeat(ranges[-1:], pad, axis=0)])
    return odom, ranges


def run_frontend(
    log: dict, cfg: FrontendConfig, device="cuda",
    state: FrontendState | None = None,
    plain: bool = False,
    frame_cb=None,
):
    """Run the frontend over a host-side log dict {odom, ranges} on `device`.

    Each chunk of cfg.chunk scans is copied to the device at once; the
    tail chunk is padded by repeating the last record and the outputs are
    truncated. `plain=True` runs every kernel's plain version (checks only).

    `frame_cb(logodds, traj_chunk)` is called at every chunk boundary (for
    animation capture), with the state's map tensor, which later scans
    update in place (copy it to keep it), and the chunk's real poses as a
    numpy [n, 3] array: one host read a chunk, so leave it None on
    throughput runs.

    Returns (final_state, traj [T, 3] np.ndarray, scores [T] np.ndarray),
    both fetched from the device in one copy.
    """
    odom = np.asarray(log["odom"], np.float32)
    ranges = np.asarray(log["ranges"], np.float32)
    T = len(odom)
    K = cfg.chunk
    if state is None:
        state = frontend_init(
            cfg, device, start_pose=odom[0], start_odom=odom[0], plain=plain
        )
    odom, ranges = _pad_log(odom, ranges, K)
    # [n_pad, 4]: the pose and the score of each scan
    out = torch.empty((len(odom), 4), dtype=torch.float32, device=device)
    for s in range(0, len(odom), K):
        state, _ = _run_chunk(state, odom[s : s + K], ranges[s : s + K], cfg,
                              out[s : s + K], plain)
        if frame_cb is not None:
            frame_cb(state.logodds, out[s : min(s + K, T), :3].cpu().numpy())
    out = out[:T].cpu().numpy()
    return state, out[:, :3].copy(), out[:, 3].copy()


def run_frontend_offline(
    log: dict, cfg: FrontendConfig, device="cuda",
    state: FrontendState | None = None,
):
    """Whole-log frontend (offline mapping), with the JAX package's
    semantics: the tail padded to a multiple of cfg.chunk by repeating
    the last record, one fetch of the trajectory, the outputs truncated;
    bit-identical to `run_frontend`. Until the chunks replay as CUDA
    graphs it runs `run_frontend`'s own loop over the padded log.

    Returns (final_state, traj [T, 3] np.ndarray, scores [T] np.ndarray).
    """
    odom = np.asarray(log["odom"], np.float32)
    ranges = np.asarray(log["ranges"], np.float32)
    T = len(odom)
    odom, ranges = _pad_log(odom, ranges, cfg.chunk)
    state, traj, scores = run_frontend(
        {"odom": odom, "ranges": ranges}, cfg, device, state=state
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
):
    """Pose tracking against a FIXED prebuilt map (no bootstrap, no map
    updates): the AMCL-style localization mode. `logodds` is an [H, W]
    log-odds map (numpy or a tensor) of cfg.grid's geometry, e.g. a
    previous run's final map; it is copied, so the caller's map comes back
    unchanged. The search space is built once, on the whole map, and the
    scans run through `run_frontend` with cfg.localize_only set: one host
    read a scan (the match gate). `start_pose` defaults to the first
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
    (one more host read), and a relocalization's pose, score and margin
    once more.

    Returns (final_state, traj [T, 3], scores [T], events): events lists
    the accepted recoveries as {"scan", "score", "margin", "pose"} dicts,
    rounded to 4 digits as the JAX package rounds them ([] without
    recover)."""
    odom = np.asarray(log["odom"], np.float32)
    cfg, state = localization_init(cfg, logodds, odom[0], device,
                                   start_pose=start_pose, plain=plain)
    if not recover:
        state, traj, scores = run_frontend(log, cfg, device, state=state,
                                           plain=plain)
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
        state, r = _run_chunk(state, odom_p[s : s + K], ranges_p[s : s + K],
                              cfg, out[s : s + K], plain)
        n_here = min(K, T - s)
        frontend_step.host_syncs += 1
        sc_h = out[s : s + n_here, 3].cpu().numpy()
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
            state.logodds, r[n_here - 1], cfg.grid, cfg.matcher, cfg.sensor,
            search_space=state.search_space, return_margin=True, plain=plain,
        )
        frontend_step.host_syncs += 1
        got = torch.cat([pose0, s0.reshape(1), m0.reshape(1)]).cpu().numpy()
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
