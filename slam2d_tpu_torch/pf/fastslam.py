"""FastSLAM particle filter, port of slam2d_tpu/pf/fastslam.py.

Particle state is a struct of stacked tensors: maps [P, H, W] (float32 or
bfloat16), poses [P, 3], log-weights [P]. Per scan: the odometry proposal
with noise; the refine of every particle against its own map (the match
score is the likelihood-field weight), which is the shared-anchor refine
(pf/shared_refine.py) from refine_shared_min_particles particles on and
the per-particle match below (`per_particle_fields`, then `match_scans`
with the correlation scorer kernel); the map update, which is
the shared-anchor update (pf/shared_update.py) from
update_shared_min_particles particles on and the per-particle update
below (`_update_all`: kernel 1 `ism`, `ray` or `hybrid` over every
particle in one launch, or the sampled-ray or dense update); and
systematic resampling when N_eff falls below its threshold (kernel:
ops/gather.py).

The stage gates (refine, update, bootstrap) are functions of the odometry
alone. `fastslam_step` has two forms, which give the same bits with the
same draws. The host-gated form takes them from the host, as a row of
`host_gate_flags` (a numpy copy of the JAX package's), so they cost no
device read, and runs only the stages that fire; the resample trigger, a
function of the weights, is the one value a refine event reads back. The
device-gated form is the JAX package's ungated step (its `lax.cond`s):
the gates and the trigger are computed on the device, every kernel of
the step launches with its gate in device memory and returns at once on
0, `torch.where` selects, and nothing is read back, so a chunk of steps
can be one CUDA graph (run/fastslam_run.py). The maps are updated IN
PLACE (the JAX package returns new arrays); the host-gated resample makes
a new map tensor, the device-gated one copies into the same tensor.

Random draws: JAX's threefry stream cannot be reproduced, so the standard
normal proposal noise [P, 3] and the resample's uniform u come from a
`torch.Generator`, or are passed in (the tests pass JAX's draws).

`fastslam_step` counts the host reads of the host-gated form
(`host_syncs`, a plain integer) and the scans that refined (`refines`),
updated the maps (`updates`) and resampled (`resamples`): the device-gated
form adds those three on the device, and reading one of them reads the
device counters back once; a caller may set them (to 0).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from slam2d_tpu_torch.config import FrontendConfig, PFConfig
from slam2d_tpu_torch.core import se2
from slam2d_tpu_torch.core.numerics import inv_f32
from slam2d_tpu_torch.grid.occupancy import (
    beam_angles,
    dense_update_particles,
    raycast_update_particles,
    resolve_update_impl,
    update_constants,
    world_to_cell,
)
from slam2d_tpu_torch.grid.window import (
    blur_halo_cells,
    scan_window_cells,
    update_window_cells,
)
from slam2d_tpu_torch.match.correlative import gaussian_kernel_1d, match_scans
from slam2d_tpu_torch.ops.field import window_field
from slam2d_tpu_torch.ops.gather import gather_rows
from slam2d_tpu_torch.ops.update import (
    update_hybrid_particles,
    update_ism,
    update_ray_particles,
)
from slam2d_tpu_torch.pf.shared_refine import shared_refine
from slam2d_tpu_torch.pf.shared_update import shared_update


class PFState(NamedTuple):
    logodds: torch.Tensor       # [P, H, W] per-particle maps
    poses: torch.Tensor         # [P, 3]
    log_w: torch.Tensor         # [P] log weights (normalized)
    prev_odom: torch.Tensor     # [3]
    dist: torch.Tensor          # scalar: cumulative odometry travel
    since_update: torch.Tensor  # scalar: travel since the last map update
    since_match: torch.Tensor   # scalar: motion since the last refine


def _resolve_refine_mode(pf: PFConfig, mcfg, local_particles: int) -> str:
    """PFConfig.refine_mode with "auto" resolved as on the JAX package's
    accelerator: the shared-anchor refine from refine_shared_min_particles
    particles on, when the matcher searches theta. An explicit "shared"
    request with a theta-less matcher is an error."""
    mode = pf.refine_mode
    if mode == "auto":
        use_shared = (
            local_particles >= pf.refine_shared_min_particles
            and mcfg.n_theta > 1
        )
        return "shared" if use_shared else "per_particle"
    if mode == "shared" and mcfg.n_theta <= 1:
        raise ValueError(
            "refine_mode='shared' needs n_theta > 1 (the shared stack is "
            "built on the global theta grid); got n_theta="
            f"{mcfg.n_theta}. Use refine_mode='per_particle' or 'auto'."
        )
    return mode


def refine_matcher(cfg: FrontendConfig, pf: PFConfig):
    """PF refinement matcher config: the frontend matcher with the
    PFConfig refine_* overrides applied (None = inherit)."""
    m = cfg.matcher
    if pf.refine_score_impl is not None:
        impl = pf.refine_score_impl
    elif m.score_impl == "auto":
        impl = "auto_refine"
    else:
        impl = m.score_impl
    pw = pf.refine_prior_weight
    return dataclasses.replace(
        m,
        search_xy=m.search_xy if pf.refine_xy is None else pf.refine_xy,
        search_theta=(
            m.search_theta if pf.refine_theta is None else pf.refine_theta
        ),
        n_theta=m.n_theta if pf.refine_n_theta is None else pf.refine_n_theta,
        score_impl=impl,
        **({} if pw is None else {
            "prior_xy_weight": pw, "prior_theta_weight": pw,
        }),
    )


def fastslam_init(cfg: FrontendConfig, pf: PFConfig, device="cuda",
                  start_pose=None):
    """Fresh state on `device`: P empty maps of pf.map_dtype, every
    particle at `start_pose`, equal weights."""
    f32 = dict(dtype=torch.float32, device=device)
    pose = (
        torch.zeros(3, **f32) if start_pose is None
        else torch.as_tensor(np.asarray(start_pose, np.float32), device=device)
    )
    P = pf.n_particles
    return PFState(
        logodds=torch.zeros(
            (P, cfg.grid.height, cfg.grid.width),
            dtype=getattr(torch, pf.map_dtype), device=device,
        ),
        poses=pose[None, :].repeat(P, 1),
        log_w=torch.zeros(P, **f32),
        prev_odom=pose.clone(),
        dist=torch.zeros((), **f32),
        since_update=torch.full((), float("inf"), **f32),  # integrate scan 0
        since_match=torch.zeros((), **f32),
    )


def pf_state_template(cfg: FrontendConfig, pf: PFConfig) -> PFState:
    """A PFState of tensors on the "meta" device with the run's shapes and
    dtypes, the counterpart of the JAX package's: the restore target of
    utils/checkpoint.load_state(path, template, device=...). It allocates
    nothing, so a [P, H, W] stack is described without being made."""
    meta = dict(dtype=torch.float32, device="meta")
    P = pf.n_particles
    return PFState(
        logodds=torch.empty((P, cfg.grid.height, cfg.grid.width),
                            dtype=getattr(torch, pf.map_dtype),
                            device="meta"),
        poses=torch.empty((P, 3), **meta),
        log_w=torch.empty(P, **meta),
        prev_odom=torch.empty(3, **meta),
        dist=torch.empty((), **meta),
        since_update=torch.empty((), **meta),
        since_match=torch.empty((), **meta),
    )


def host_gate_flags(odom, cfg: FrontendConfig, prev_odom, dist0=0.0,
                    since_u0=0.0, since_m0=0.0):
    """Host mirror of fastslam_step's motion gates (all odometry-derived),
    the JAX package's host_gate_flags operation for operation.

    `prev_odom` is the record preceding odom[0] (the state's carried
    prev_odom: odom[0] itself for a fresh start). The accumulators start
    from the state's scalars. Returns [T, 3] bool (do_refine, do_update,
    in_boot)."""
    odom = np.asarray(odom, np.float32)
    T = len(odom)
    flags = np.zeros((T, 3), bool)
    dist = np.float32(dist0)
    su = np.float32(since_u0)
    sm = np.float32(since_m0)
    prev = np.asarray(prev_odom, np.float32)
    ratio = np.float32(cfg.match_min_motion / max(cfg.match_min_rot, 1e-6))
    for t in range(len(odom)):
        o = odom[t]
        dx, dy = o[0] - prev[0], o[1] - prev[1]
        # the op set of se2.between: rotate into prev's frame first
        c, s = np.cos(prev[2], dtype=np.float32), np.sin(prev[2], dtype=np.float32)
        bx = c * dx + s * dy
        by = -s * dx + c * dy
        step_len = np.float32(np.hypot(bx, by))
        dth = np.float32((o[2] - prev[2] + np.pi) % (2 * np.pi) - np.pi)
        in_boot = bool(dist < cfg.bootstrap_dist)
        sm = np.float32(sm + step_len + np.abs(dth) * ratio)
        do_refine = (not in_boot) and bool(sm >= cfg.match_min_motion)
        if do_refine:
            sm = np.float32(0.0)
        su = np.float32(su + step_len)
        do_update = in_boot or bool(su >= cfg.map_update_min_motion)
        if do_update:
            su = np.float32(0.0)
        dist = np.float32(dist + step_len)
        flags[t] = (do_refine, do_update, in_boot)
        prev = o
    return flags


def per_particle_windows(priors, cfg, mcfg, H, W):
    """(size, origins [P, 2] int32 row/col, origins [P, 2] world x, y) of
    each particle's scan window around its prior's cell, clamped into an
    H x W map (the whole map when the window covers it; JAX's
    _windowed_match)."""
    g = cfg.grid
    P = priors.shape[0]
    res = g.resolution
    win = scan_window_cells(g, cfg.sensor, mcfg)
    if win >= min(H, W):
        # cells past the map read 0, then cropped
        origins = torch.zeros((P, 2), dtype=torch.int32, device=priors.device)
        origin_xy = torch.tensor(
            [[g.origin_x, g.origin_y]], dtype=torch.float32,
            device=priors.device,
        ).expand(P, 2)
        return max(H, W), origins, origin_xy
    center = world_to_cell(priors[:, :2], g)
    r0 = torch.clamp(center[:, 0] - win // 2, 0, H - win)
    c0 = torch.clamp(center[:, 1] - win // 2, 0, W - win)
    origins = torch.stack([r0, c0], dim=1).to(torch.int32)
    origin_xy = torch.stack(
        [g.origin_x + c0.to(torch.float32) * res,
         g.origin_y + r0.to(torch.float32) * res],
        dim=1,
    )
    return win, origins, origin_xy


def per_particle_fields(logodds, priors, cfg, mcfg, plain=False, gate=None):
    """(S [P, h, w] float32, origins [P, 2] world x, y): each particle's
    search space over its scan window (per_particle_windows), all built in
    one launch of the field kernel (ops/field.py), which returns at once
    where the bool device tensor `gate` is false (S is then not to be
    read)."""
    res = cfg.grid.resolution
    P, H, W = logodds.shape
    size, origins, origin_xy = per_particle_windows(priors, cfg, mcfg, H, W)
    thr = mcfg.free_threshold
    S = window_field(
        logodds, origins, size,
        gaussian_kernel_1d(mcfg.sigma_m / res, blur_halo_cells(mcfg, res)),
        inv_sat=1.0 / mcfg.occ_evidence_sat,
        free_logit=math.log(thr / (1.0 - thr)),
        free_penalty=mcfg.free_penalty, out_dtype=torch.float32, gate=gate,
        plain=plain,
    )
    if size > min(H, W):
        S = S[:, :H, :W].contiguous()
    return S, origin_xy


def _refine_all(logodds, ranges, priors, cfg, pf, plain=False, gate=None):
    """(matched poses [P, 3], scores [P]) of every particle's refine: the
    shared-anchor refine or the per-particle one, as `refine_mode`
    resolves. Where the bool device tensor `gate` is false the kernels
    return at once and the result is not to be read."""
    mcfg = refine_matcher(cfg, pf)
    mode = _resolve_refine_mode(pf, mcfg, pf.n_particles)
    if mode == "shared":
        return shared_refine(
            logodds, ranges, priors, cfg, mcfg, pf, plain=plain, gate=gate
        )
    # every particle's own match against its own map, batched (the JAX
    # package's vmap of _windowed_match), one scorer launch per pass
    S, origin_xy = per_particle_fields(logodds, priors, cfg, mcfg,
                                       plain=plain, gate=gate)
    return match_scans(
        S, origin_xy, ranges, priors, cfg.grid, mcfg, cfg.sensor, plain=plain,
        gate=gate,
    )


def _update_all(logodds, poses, ranges, cfg, pf, plain=False, gate=None):
    """Integrate the scan into every particle's map at its pose, IN PLACE.

    PFConfig.update_mode picks the batching, "auto" as on the JAX
    package's accelerator: the shared-anchor update (pf/shared_update.py:
    G carve images, kernel 8 adds them with the exact endpoint marks) from
    update_shared_min_particles particles on, else the per-particle update
    over the update window around each pose (the JAX package's vmap of
    pf/fastslam.py's _windowed_update; the whole map when the window is
    not narrower), every particle at once, by GridConfig.update_impl as
    `resolve_update_impl(..., auto_ctx="pf")` resolves it: kernel 1 `ism`
    ("pallas", the "auto" of fields of view up to pi), `ray`
    ("pallas_ray") or `hybrid` ("pallas_hybrid") with a grid axis over the
    particles; the sampled-ray update ("sparse", "sparse_mxu", the "auto"
    past pi) in one index_put_ over the stack; the dense one ("dense").
    The quantized_* modes are diagnostics of the JAX package and raise.
    Where the bool device tensor `gate` is false the maps keep their bits
    (each form takes the gate: see pf/shared_update.py, ops/update.py,
    grid/occupancy.py)."""
    mode = pf.update_mode
    if mode == "auto":
        mode = (
            "shared" if pf.n_particles >= pf.update_shared_min_particles
            else "per_particle"
        )
    if mode == "shared":
        return shared_update(logodds, poses, ranges, cfg, pf, plain=plain,
                             gate=gate)
    if mode != "per_particle":
        raise NotImplementedError(
            f"update_mode={mode!r}: the quantized_* update modes are "
            "diagnostics of the JAX package and are not ported"
        )
    g, s = cfg.grid, cfg.sensor
    impl = resolve_update_impl(g, s, auto_ctx="pf")
    H, W = logodds.shape[1:]
    win = update_window_cells(g, s)
    region = (win, win) if win < min(H, W) else (H, W)
    if impl in ("sparse", "sparse_mxu"):
        return raycast_update_particles(logodds, poses, ranges, g, s, region,
                                        gate=gate)
    if impl == "dense":
        return dense_update_particles(logodds, poses, ranges, g, s, region,
                                      gate=gate)
    consts = update_constants(g, s)
    origin_xy = (g.origin_x, g.origin_y)
    if impl == "pallas":
        return update_ism(
            logodds, poses, ranges, region=region, origin_xy=origin_xy,
            gate=gate, plain=plain, **consts,
        )
    angles = beam_angles(s, logodds.device)
    if impl == "pallas_ray":
        return update_ray_particles(
            logodds, poses, ranges, angles, region=region,
            origin_xy=origin_xy, resolution=g.resolution,
            min_range=s.min_range, max_range=s.max_range,
            angle_min=s.angle_min, step=consts["step"], l_free=g.l_free,
            l_occ=g.l_occ, l_clamp=g.l_clamp, ray_samples=g.ray_samples,
            gate=gate, plain=plain,
        )
    return update_hybrid_particles(
        logodds, poses, ranges, angles, region=region, origin_xy=origin_xy,
        gate=gate, plain=plain, **consts,
    )


def _resample_copy(stacked, ancestors, plain=False):
    """Copy ancestor rows of a [P, ...] tensor (a new tensor)."""
    return gather_rows(stacked, ancestors, plain=plain)


def _softmax(log_w):
    """jax.nn.softmax's operations: exp(x - max) / sum."""
    e = torch.exp(log_w - log_w.max())
    return e / e.sum()


def effective_sample_size(log_w):
    w = _softmax(log_w)
    return 1.0 / (w * w).sum()


def systematic_ancestors(log_w, u):
    """Low-variance (systematic) resampling ancestor indices.

    One uniform u ~ U[0, 1) (a 0-d tensor); ancestor k is where (u + k)/P
    falls in the normalized-weight CDF. Returns int32 [P]."""
    P = log_w.shape[0]
    cdf = torch.cumsum(_softmax(log_w), dim=0)
    k = torch.arange(P, dtype=torch.float32, device=log_w.device)
    pts = (u + k) * inv_f32(P)   # XLA's form of (u + k) / P
    idx = torch.searchsorted(cdf, pts, right=False)
    return torch.clamp(idx, 0, P - 1).to(torch.int32)


@functools.cache
def _noise_scale(pf: PFConfig, device) -> torch.Tensor:
    """[noise_xy, noise_xy, noise_theta] on `device`, cached so a step
    copies nothing from the host. Callers must not write into it."""
    return torch.tensor(
        [pf.noise_xy, pf.noise_xy, pf.noise_theta], dtype=torch.float32,
        device=device,
    )


def _motion(state, odom, cfg):
    """(delta [3], step length, motion since the last refine and since the
    last update, each with this scan's) of the odometry step."""
    delta = se2.between(state.prev_odom, odom)
    step_len = torch.hypot(delta[0], delta[1])
    rot_equiv = torch.abs(se2.wrap_angle(delta[2])) * (
        cfg.match_min_motion / max(cfg.match_min_rot, 1e-6)
    )
    return (delta, step_len, state.since_match + step_len + rot_equiv,
            state.since_update + step_len)


def _step_host_gated(state, odom, ranges, cfg, pf, gates, noise, u,
                     generator, plain, count):
    """`fastslam_step` with the gates as host bools (its docstring)."""
    P = pf.n_particles
    dev = state.poses.device
    delta, step_len, since_m, since = _motion(state, odom, cfg)
    do_refine, do_update, boot = (bool(g) for g in gates)

    if do_refine or boot:
        if noise is None:
            noise = torch.randn((P, 3), generator=generator, device=dev)
        noise = noise * _noise_scale(pf, dev)
    log_w = state.log_w
    scores = torch.full((P,), -1.0, dtype=torch.float32, device=dev)
    if do_refine:
        count("refines")
        priors = se2.compose(state.poses, delta[None, :] + noise)
        poses, scores = _refine_all(
            state.logodds, ranges, priors, cfg, pf, plain=plain
        )
        # log-space likelihood-field weights, normalized (logsumexp's
        # operations: log(sum(exp(x - max))) + max)
        log_w = _normalized(log_w + pf.weight_sharpness * scores)
        since_m = torch.zeros_like(since_m)
    elif boot:
        # bootstrap: noisy propagation builds particle diversity
        poses = se2.compose(state.poses, delta[None, :] + noise)
    else:
        poses = se2.compose(state.poses, delta[None, :])

    logodds = state.logodds
    if do_update:
        count("updates")
        _update_all(logodds, poses, ranges, cfg, pf, plain=plain)
        since = torch.zeros_like(since)

    # resample on the N_eff trigger (only meaningful after a refine)
    n_eff = effective_sample_size(log_w)
    if do_refine:
        fastslam_step.host_syncs += 1
        if bool(n_eff < pf.resample_threshold * P):
            count("resamples")
            if u is None:
                u = torch.rand((), generator=generator, device=dev)
            ancestors = systematic_ancestors(log_w, u)
            logodds = _resample_copy(logodds, ancestors, plain=plain)
            poses = poses.index_select(0, ancestors)
            log_w = torch.full_like(log_w, _uniform_log_w(P))

    return _finish(state, logodds, poses, log_w, odom, step_len, since,
                   since_m, n_eff, scores)


def _step_device_gated(state, odom, ranges, cfg, pf, noise, u, generator,
                       plain, host_branch, counts, scratch):
    """`fastslam_step` with the gates on the device (its docstring)."""
    P = pf.n_particles
    dev = state.poses.device
    if host_branch is None:
        host_branch = dev.type == "cpu"
    delta, step_len, since_m, since = _motion(state, odom, cfg)
    in_boot = state.dist < cfg.bootstrap_dist
    do_refine = ~in_boot & (since_m >= cfg.match_min_motion)
    do_update = in_boot | (since >= cfg.map_update_min_motion)

    # JAX's draws: noise and a uniform every scan, whatever fires
    if noise is None:
        noise = torch.randn((P, 3), generator=generator, device=dev)
    if u is None:
        u = torch.rand((), generator=generator, device=dev)
    proposal = se2.compose(
        state.poses, delta[None, :] + noise * _noise_scale(pf, dev)
    )
    poses = torch.where(
        in_boot, proposal, se2.compose(state.poses, delta[None, :])
    )
    log_w = state.log_w
    scores = torch.full((P,), -1.0, dtype=torch.float32, device=dev)
    if not host_branch or bool(do_refine):
        refined, sc = _refine_all(
            state.logodds, ranges, proposal, cfg, pf, plain=plain,
            gate=do_refine,
        )
        poses = torch.where(do_refine, refined, poses)
        log_w = torch.where(
            do_refine, _normalized(log_w + pf.weight_sharpness * sc), log_w
        )
        scores = torch.where(do_refine, sc, scores)
    since_m = torch.where(do_refine, 0.0, since_m)

    logodds = state.logodds
    if not host_branch or bool(do_update):
        _update_all(logodds, poses, ranges, cfg, pf, plain=plain,
                    gate=do_update)
    since = torch.where(do_update, 0.0, since)

    n_eff = effective_sample_size(log_w)
    trigger = do_refine & (n_eff < pf.resample_threshold * P)
    if not host_branch or bool(trigger):
        ancestors = systematic_ancestors(log_w, u)
        # out[p] = maps[anc[p]] through a scratch stack and back, each copy
        # gated on the trigger, so the maps keep their address
        if scratch is None:
            scratch = torch.empty_like(logodds)
        gather_rows(logodds, ancestors, plain=plain, gate=trigger,
                    out=scratch)
        gather_rows(scratch, _identity(P, dev), plain=plain, gate=trigger,
                    out=logodds)
        poses = torch.where(trigger, poses.index_select(0, ancestors), poses)
        log_w = torch.where(trigger, _uniform_log_w(P), log_w)
    if counts is None:
        counts = fastslam_step.counter(dev)
    counts += torch.stack([do_refine, do_update, trigger])
    return _finish(state, logodds, poses, log_w, odom, step_len, since,
                   since_m, n_eff, scores)


def _normalized(log_w):
    """log_w - logsumexp(log_w), with logsumexp's operations:
    log(sum(exp(x - max))) + max."""
    m = log_w.max()
    return log_w - (torch.log(torch.exp(log_w - m).sum()) + m)


def _uniform_log_w(P: int) -> float:
    """-log(P) in float32, the weights after a resample."""
    return -float(np.log(np.float32(P), dtype=np.float32))


@functools.cache
def _identity(P: int, device) -> torch.Tensor:
    """int32 [0, P) on `device` (the copy back of the gated resample),
    cached so a step makes nothing. Callers must not write into it."""
    return torch.arange(P, dtype=torch.int32, device=device)


def _finish(state, logodds, poses, log_w, odom, step_len, since, since_m,
            n_eff, scores):
    """The new state and the scan's (best pose, N_eff, best score)."""
    best = torch.argmax(log_w).reshape(1)
    new_state = PFState(
        logodds, poses, log_w, odom, state.dist + step_len, since, since_m
    )
    return new_state, (
        poses.index_select(0, best)[0], n_eff, scores.index_select(0, best)[0]
    )


_COUNTS = ("refines", "updates", "resamples")


class _FastslamStep:
    """`fastslam_step`: one scan, with its counters (see the module doc)."""

    def __init__(self):
        self.host_syncs = 0
        self._ints = dict.fromkeys(_COUNTS, 0)
        self._pending = {}   # device -> int64 [3] (refines, updates, resamples)

    def __call__(self, state, odom, ranges, cfg, pf, gates=None, noise=None,
                 u=None, generator=None, plain=False, host_branch=None,
                 counts=None, scratch=None):
        if gates is not None:
            return _step_host_gated(state, odom, ranges, cfg, pf, gates,
                                    noise, u, generator, plain, self._count)
        return _step_device_gated(state, odom, ranges, cfg, pf, noise, u,
                                  generator, plain, host_branch, counts,
                                  scratch)

    def _count(self, name):
        self._ints[name] += 1

    def counter(self, device) -> torch.Tensor:
        """The device's int64 [3] (refines, updates, resamples) accumulator
        that device-gated steps given no `counts` add to (made on first
        use: outside a graph capture)."""
        key = torch.device(device)
        if key not in self._pending:
            self._pending[key] = torch.zeros(3, dtype=torch.int64, device=key)
        return self._pending[key]

    def _flush(self):
        for acc in self._pending.values():
            for name, n in zip(_COUNTS, acc.cpu().tolist()):
                self._ints[name] += n
            acc.zero_()

    def _get(name):
        def get(self):
            self._flush()
            return self._ints[name]

        def set_(self, value):
            self._flush()
            self._ints[name] = int(value)

        return property(get, set_)

    refines = _get("refines")
    updates = _get("updates")
    resamples = _get("resamples")
    del _get


fastslam_step = _FastslamStep()
fastslam_step.__doc__ = """One scan for all particles. Returns (state, (best_pose [3], n_eff,
best_score)) as tensors on the state's device.

`odom` [3] and `ranges` [B] are float32 tensors on that device. `noise`
[P, 3] is the standard normal proposal draw and `u` the resample's
uniform (0-d); None draws them from `generator`. The maps of `state` are
updated in place. `plain=True` runs every kernel's plain version even
on a CUDA device (for checks).

Two forms, with the same bits given the same draws:
- `gates` = (do_refine, do_update, in_boot) as host bools, the scan's row
  of `host_gate_flags`: only the stages that fire run; the noise is drawn
  and used on refine and bootstrap scans, u on resampling scans; a refine
  reads the resample trigger back (`host_syncs`); a resample makes a new
  map tensor.
- `gates=None`, the JAX package's ungated step: the gates and the
  resample trigger are computed on the device from the state, the noise
  and u drawn on every scan; the refine, the update and the resample's
  row gathers launch on every scan with the gate in device memory
  (their kernels return at once on 0) and `torch.where` selects. The
  maps keep their address: the resample gathers into `scratch` (None: a
  new stack) and back, both gated. Nothing is read to the host, and the
  gates are added to `counts` (int64 [3] on the device; None: the step's
  own accumulator). `host_branch` (default: on the CPU) reads each gate
  and skips the gated-off work instead, with the same bits.

FastSLAM-2.0-flavoured proposal: each particle refines its odometry +
noise proposal against its own map; the match score is the
likelihood-field weight update. Between refines the particles dead-reckon
on odometry; during bootstrap they propagate with noise.
"""


def _to_torch(a, device):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes' numpy bfloat16: move the bits
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16
        ).to(device)
    return torch.as_tensor(np.array(a, np.float32), device=device)


def pf_state_from_numpy(arrays, device) -> PFState:
    """PFState on `device` from a JAX PFState (or a mapping of its field
    names to arrays), e.g. `jax_state` itself: its fields are read by
    name, as numpy, and its PRNG key is not carried over. bfloat16 maps
    move bit for bit."""
    get = arrays._asdict() if hasattr(arrays, "_asdict") else dict(arrays)
    return PFState(*(_to_torch(get[f], device) for f in PFState._fields))


def pf_state_to_numpy(state: PFState) -> PFState:
    """The state's fields as numpy arrays (a PFState). bfloat16 maps come
    back as ml_dtypes' numpy bfloat16, bit for bit, where ml_dtypes is
    installed, and as their uint16 bits otherwise."""
    def conv(t):
        t = t.detach().cpu()
        if t.dtype != torch.bfloat16:
            return t.numpy()
        bits = t.view(torch.int16).numpy().view(np.uint16)
        try:
            import ml_dtypes
        except ImportError:
            return bits
        return bits.view(ml_dtypes.bfloat16)

    return PFState(*(conv(t) for t in state))
