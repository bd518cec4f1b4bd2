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
alone. `fastslam_step` takes them from the host, as a row of
`host_gate_flags` (a numpy copy of the JAX package's), so they cost no
device read. Each scan then runs only the stages that fire,
so no map-shaped select is ever made: this is the function of the JAX
package's ungated `fastslam_step`, not its TPU dispatch machinery. The
resample trigger, a function of the weights, is the one value a refine
event reads back. The maps are updated IN PLACE (the JAX package returns
new arrays); a resample makes a new map tensor.

Random draws: JAX's threefry stream cannot be reproduced, so the standard
normal proposal noise [P, 3] and the resample's uniform u come from a
`torch.Generator`, or are passed in (the tests pass JAX's draws).

Plain integers on `fastslam_step` count the host reads (`host_syncs`)
and the scans that refined (`refines`), updated the maps (`updates`) and
resampled (`resamples`); a caller may reset them.
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


def per_particle_fields(logodds, priors, cfg, mcfg, plain=False):
    """(S [P, h, w] float32, origins [P, 2] world x, y): each particle's
    search space over its scan window (per_particle_windows), all built in
    one launch of the field kernel (ops/field.py)."""
    res = cfg.grid.resolution
    P, H, W = logodds.shape
    size, origins, origin_xy = per_particle_windows(priors, cfg, mcfg, H, W)
    thr = mcfg.free_threshold
    S = window_field(
        logodds, origins, size,
        gaussian_kernel_1d(mcfg.sigma_m / res, blur_halo_cells(mcfg, res)),
        inv_sat=1.0 / mcfg.occ_evidence_sat,
        free_logit=math.log(thr / (1.0 - thr)),
        free_penalty=mcfg.free_penalty, out_dtype=torch.float32, plain=plain,
    )
    if size > min(H, W):
        S = S[:, :H, :W].contiguous()
    return S, origin_xy


def _refine_all(logodds, ranges, priors, cfg, pf, plain=False):
    """(matched poses [P, 3], scores [P]) of every particle's refine: the
    shared-anchor refine or the per-particle one, as `refine_mode`
    resolves."""
    mcfg = refine_matcher(cfg, pf)
    mode = _resolve_refine_mode(pf, mcfg, pf.n_particles)
    if mode == "shared":
        return shared_refine(
            logodds, ranges, priors, cfg, mcfg, pf, plain=plain
        )
    # every particle's own match against its own map, batched (the JAX
    # package's vmap of _windowed_match), one scorer launch per pass
    S, origin_xy = per_particle_fields(logodds, priors, cfg, mcfg, plain=plain)
    return match_scans(
        S, origin_xy, ranges, priors, cfg.grid, mcfg, cfg.sensor, plain=plain
    )


def _update_all(logodds, poses, ranges, cfg, pf, plain=False):
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
    The quantized_* modes are diagnostics of the JAX package and raise."""
    mode = pf.update_mode
    if mode == "auto":
        mode = (
            "shared" if pf.n_particles >= pf.update_shared_min_particles
            else "per_particle"
        )
    if mode == "shared":
        return shared_update(logodds, poses, ranges, cfg, pf, plain=plain)
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
        return raycast_update_particles(logodds, poses, ranges, g, s, region)
    if impl == "dense":
        return dense_update_particles(logodds, poses, ranges, g, s, region)
    consts = update_constants(g, s)
    origin_xy = (g.origin_x, g.origin_y)
    if impl == "pallas":
        return update_ism(
            logodds, poses, ranges, region=region, origin_xy=origin_xy,
            plain=plain, **consts,
        )
    angles = beam_angles(s, logodds.device)
    if impl == "pallas_ray":
        return update_ray_particles(
            logodds, poses, ranges, angles, region=region,
            origin_xy=origin_xy, resolution=g.resolution,
            min_range=s.min_range, max_range=s.max_range,
            angle_min=s.angle_min, step=consts["step"], l_free=g.l_free,
            l_occ=g.l_occ, l_clamp=g.l_clamp, ray_samples=g.ray_samples,
            plain=plain,
        )
    return update_hybrid_particles(
        logodds, poses, ranges, angles, region=region, origin_xy=origin_xy,
        plain=plain, **consts,
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


def fastslam_step(
    state: PFState, odom, ranges, cfg: FrontendConfig, pf: PFConfig,
    gates, noise=None, u=None, generator=None, plain: bool = False,
):
    """One scan for all particles. Returns (state, (best_pose [3], n_eff,
    best_score)) as tensors on the state's device.

    `odom` [3] and `ranges` [B] are float32 tensors on that device.
    `gates` is (do_refine, do_update, in_boot) as host bools: the scan's
    row of `host_gate_flags`. `noise` [P, 3] is the standard normal proposal draw and `u` the
    resample's uniform (0-d); None draws them from `generator`. The noise
    is used on refine and bootstrap scans, u on resampling scans. The
    maps of `state` are updated in place. `plain=True` runs every
    kernel's plain version even on a CUDA device (for checks).

    FastSLAM-2.0-flavoured proposal: each particle refines its odometry +
    noise proposal against its own map; the match score is the
    likelihood-field weight update. Between refines the particles
    dead-reckon on odometry; during bootstrap they propagate with noise.
    """
    P = pf.n_particles
    dev = state.poses.device
    delta = se2.between(state.prev_odom, odom)
    step_len = torch.hypot(delta[0], delta[1])
    rot_equiv = torch.abs(se2.wrap_angle(delta[2])) * (
        cfg.match_min_motion / max(cfg.match_min_rot, 1e-6)
    )
    since_m = state.since_match + step_len + rot_equiv
    since = state.since_update + step_len
    do_refine, do_update, boot = (bool(g) for g in gates)

    if do_refine or boot:
        if noise is None:
            noise = torch.randn((P, 3), generator=generator, device=dev)
        noise = noise * _noise_scale(pf, dev)
    log_w = state.log_w
    scores = torch.full((P,), -1.0, dtype=torch.float32, device=dev)
    if do_refine:
        fastslam_step.refines += 1
        priors = se2.compose(state.poses, delta[None, :] + noise)
        poses, scores = _refine_all(
            state.logodds, ranges, priors, cfg, pf, plain=plain
        )
        # log-space likelihood-field weights, normalized (logsumexp's
        # operations: log(sum(exp(x - max))) + max)
        log_w = log_w + pf.weight_sharpness * scores
        m = log_w.max()
        log_w = log_w - (torch.log(torch.exp(log_w - m).sum()) + m)
        since_m = torch.zeros_like(since_m)
    elif boot:
        # bootstrap: noisy propagation builds particle diversity
        poses = se2.compose(state.poses, delta[None, :] + noise)
    else:
        poses = se2.compose(state.poses, delta[None, :])

    logodds = state.logodds
    if do_update:
        fastslam_step.updates += 1
        _update_all(logodds, poses, ranges, cfg, pf, plain=plain)
        since = torch.zeros_like(since)

    # resample on the N_eff trigger (only meaningful after a refine)
    n_eff = effective_sample_size(log_w)
    if do_refine:
        fastslam_step.host_syncs += 1
        if bool(n_eff < pf.resample_threshold * P):
            fastslam_step.resamples += 1
            if u is None:
                u = torch.rand((), generator=generator, device=dev)
            ancestors = systematic_ancestors(log_w, u)
            logodds = _resample_copy(logodds, ancestors, plain=plain)
            poses = poses.index_select(0, ancestors)
            log_w = torch.full_like(
                log_w, -float(np.log(np.float32(P), dtype=np.float32))
            )

    best = torch.argmax(log_w).reshape(1)
    new_state = PFState(
        logodds, poses, log_w, odom, state.dist + step_len, since, since_m
    )
    return new_state, (
        poses.index_select(0, best)[0], n_eff, scores.index_select(0, best)[0]
    )


fastslam_step.host_syncs = 0
fastslam_step.refines = 0
fastslam_step.updates = 0
fastslam_step.resamples = 0


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
