"""FastSLAM with its particles split over the ranks of a mesh, port of
slam2d_tpu/pf/sharded.py (BASELINE config 4).

Each rank holds its own block of Pl = P / world_size particles: maps
[Pl, H, W], poses [Pl, 3], log-weights [Pl]; the odometry carry
(prev_odom, dist, since_update, since_match) is replicated. A scan:

- refine and update run on the local block, every mode ("auto" refine
  and update, their shared-anchor means) decided on Pl
  (`pf_local = replace(pf, n_particles=Pl)`), as the JAX package
  decides them, reusing pf/fastslam.py's `_refine_all` and
  `_update_all`;
- the weights are normalized over every rank by one all_gather of each
  rank's packed [max, sum e, sum e^2] (`_global_log_normalize`); the
  resample trigger is the global N_eff (one host read a refine);
- a resample computes the global ancestors (`systematic_ancestors` over
  the all-gathered log-weights, packed with the poses in one
  all_gather), and the maps move through the bounded ring of JAX's
  `ring_exchange` (`ring_exchange` here): d_max is the pmax of every
  particle's ring distance to its ancestor, each hop shifts a [Pl, H*W]
  block one rank along the ring, and the rows a hop delivers are copied
  by the row gather (kernel 4, ops/gather.py) in place of JAX's one-hot
  matmul: a bit-exact copy;
- the best pose comes from one packed all_gather of each rank's
  (weight, pose, score), chosen before the resample, as JAX's sharded
  step chooses it.

The stage gates come from the odometry on the host (`host_gate_flags`),
the same on every rank. A rank never branches on a value only it has:
the resample trigger, d_max and the best rank are reduced from gathered
arrays, in the same order, on every rank.

Draws: `noise` [P, 3] (the whole filter's standard normal proposal draw;
each rank keeps its rows) and `u` can be passed in. Under a seed every
rank draws the whole [P, 3] from an identically seeded torch.Generator,
so with the same seed any world size sees the single-device port's
draws. JAX's per-shard `fold_in(key, shard)` stream is not copied (the
tests pass JAX's draws in).

Plain integers on `sharded_step` count host reads (`host_syncs`), refine
scans (`refines`), map updates (`updates`) and resamples
(`resamples`); on `ring_exchange` the hops run (`hops`) and each
resample's d_max (`d_max`, a list); a caller may reset them.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from slam2d_tpu_torch.config import FrontendConfig, PFConfig
from slam2d_tpu_torch.core import se2
from slam2d_tpu_torch.ops.gather import gather_rows
from slam2d_tpu_torch.parallel.mesh import Mesh
from slam2d_tpu_torch.pf.fastslam import (
    PFState,
    _noise_scale,
    _refine_all,
    _update_all,
    systematic_ancestors,
)


def local_count(pf: PFConfig, mesh: Mesh) -> int:
    """Pl, the particles of one rank; P must divide over the ranks."""
    n = mesh.world_size
    if pf.n_particles % n:
        raise ValueError(f"n_particles={pf.n_particles} must divide over "
                         f"{n} ranks")
    return pf.n_particles // n


def place_state(state: PFState, mesh: Mesh) -> PFState:
    """This rank's block of a whole state (tensors on any device): rows
    [rank * Pl, (rank + 1) * Pl) of the maps, poses and weights, copied
    to the mesh's device, and the replicated fields."""
    P = state.poses.shape[0]
    n = mesh.world_size
    if P % n:
        raise ValueError(f"{P} particles do not divide over {n} ranks")
    Pl = P // n
    lo = mesh.rank * Pl
    dev = mesh.device

    def own(t):
        return t.to(dev, copy=True).contiguous()

    return PFState(
        logodds=own(state.logodds[lo : lo + Pl]),
        poses=own(state.poses[lo : lo + Pl]),
        log_w=own(state.log_w[lo : lo + Pl]),
        prev_odom=own(state.prev_odom), dist=own(state.dist),
        since_update=own(state.since_update),
        since_match=own(state.since_match),
    )


def gather_state(state: PFState, mesh: Mesh, dst: int = 0):
    """The whole state on rank `dst` (its device), from every rank's
    block: the inverse of place_state, for checkpoints. None on the other
    ranks."""
    parts = [mesh.gather_to(t, dst)
             for t in (state.logodds, state.poses, state.log_w)]
    if mesh.rank != dst:
        return None
    maps, poses, log_w = (torch.cat(p) for p in parts)
    return PFState(maps, poses, log_w, state.prev_odom.clone(),
                   state.dist.clone(), state.since_update.clone(),
                   state.since_match.clone())


def sharded_fastslam_init(cfg: FrontendConfig, pf: PFConfig, mesh: Mesh,
                          start_pose=None) -> PFState:
    """A fresh state's block on the mesh's device, made there: Pl empty
    maps of pf.map_dtype (the whole [P, H, W] stack is never made),
    every particle at `start_pose`, equal weights."""
    Pl = local_count(pf, mesh)
    dev = mesh.device
    f32 = dict(dtype=torch.float32, device=dev)
    pose = (
        torch.zeros(3, **f32) if start_pose is None
        else torch.as_tensor(np.asarray(start_pose, np.float32), device=dev)
    )
    return PFState(
        logodds=torch.zeros((Pl, cfg.grid.height, cfg.grid.width),
                            dtype=getattr(torch, pf.map_dtype), device=dev),
        poses=pose[None, :].repeat(Pl, 1),
        log_w=torch.zeros(Pl, **f32),
        prev_odom=pose.clone(),
        dist=torch.zeros((), **f32),
        since_update=torch.full((), float("inf"), **f32),
        since_match=torch.zeros((), **f32),
    )


def _global_log_normalize(log_w, mesh: Mesh):
    """(log_w normalized over every rank, n_eff), JAX's arithmetic: each
    rank packs its (max, sum exp(lw - max), sum exp(2 (lw - max))), one
    all_gather replicates every rank's, and the global logsumexp and
    N_eff = Z^2 / S2 are reassembled. A rank whose weights are all -inf
    adds 0, not NaN (its max is kept finite). The weights are normalized
    as log_w - (log Z + max), the single-device step's order, so that a
    world of one normalizes to its bits."""
    m_loc = torch.clamp_min(log_w.max(), -1e30)
    e = torch.exp(log_w - m_loc)
    stats = mesh.all_gather(torch.stack([m_loc, e.sum(), (e * e).sum()]))
    m = stats[:, 0].max()
    sc = torch.exp(stats[:, 0] - m)
    z = (stats[:, 1] * sc).sum()
    s2 = (stats[:, 2] * sc * sc).sum()
    return log_w - (torch.log(z) + m), (z * z) / s2


def ring_exchange(maps, want, mesh: Mesh, plain: bool = False):
    """maps_new[p] = the map of global particle want[p] (int32 [Pl]), for
    the local block `maps` [Pl, ...], through the bounded ring: hop 0
    copies the rows whose ancestor is local, hop k the rows whose
    ancestor lives k ranks back, after shifting the block that arrived
    at hop k - 1 one rank on. d_max, the pmax of the ring distances, is
    read to the host and bounds the hops (every rank takes the same
    number). Each hop's rows are copied by kernel 4 over the pair [rows
    so far; block that arrived], the second half copied to itself (the
    block forwarded at the next hop). Returns (maps_new, k_need [Pl]
    int32: each row's ring distance)."""
    Pl = maps.shape[0]
    n, r = mesh.world_size, mesh.rank
    dev = maps.device
    flat = maps.reshape(Pl, -1)
    w = want.to(torch.int64)
    src = torch.div(w, Pl, rounding_mode="floor")
    k_need = torch.remainder(r - src, n)
    local = w - src * Pl
    sharded_step.host_syncs += 1
    d_max = int(mesh.pmax(k_need.max().reshape(1)).item())
    ring_exchange.d_max.append(d_max)
    ar = torch.arange(Pl, device=dev)
    anc = torch.where(k_need == 0, local, ar).to(torch.int32)
    out = gather_rows(flat, anc, plain=plain)
    blk = flat
    for k in range(1, d_max + 1):
        ring_exchange.hops += 1
        pair = torch.empty((2 * Pl, flat.shape[1]), dtype=flat.dtype,
                           device=dev)
        mesh.ppermute(blk, out=pair[Pl:])
        pair[:Pl].copy_(out)
        anc = torch.cat([torch.where(k_need == k, Pl + local, ar),
                         Pl + ar]).to(torch.int32)
        pair = gather_rows(pair, anc, plain=plain)
        out, blk = pair[:Pl], pair[Pl:]
    return out.reshape(maps.shape), k_need.to(torch.int32)


ring_exchange.hops = 0
ring_exchange.d_max = []


def _best(log_w, poses, scores, mesh: Mesh):
    """(best pose [3], its score): each rank's best particle packed as
    (weight, x, y, theta, score), one all_gather, the first rank of the
    largest weight."""
    b = torch.argmax(log_w).reshape(1)
    cand = torch.cat([log_w.index_select(0, b), poses.index_select(0, b)[0],
                      scores.index_select(0, b)])
    cands = mesh.all_gather(cand)                           # [n, 5]
    k = torch.argmax(cands[:, 0]).reshape(1)
    row = cands.index_select(0, k)[0]
    return row[1:4], row[4]


def sharded_step(state: PFState, odom, ranges, cfg: FrontendConfig,
                 pf: PFConfig, mesh: Mesh, gates, n_eff=None, noise=None,
                 u=None, generator=None, plain: bool = False):
    """One scan of this rank's block (module docstring). Returns (state,
    (best_pose [3], n_eff, best_score, n_eff_carry)), tensors on the
    mesh's device, the same on every rank.

    `gates` is the scan's row of `host_gate_flags` (do_refine, do_update,
    in_boot). `n_eff` is the carried N_eff of the weights as they stand
    (the previous scan's `n_eff_carry`): a scan that does not refine
    leaves the weights as they are and reports it without a collective;
    None computes it. `noise` [P, 3] (the whole filter's; this rank keeps
    its rows) and `u` (0-d) replace the draws of `generator`. The maps are
    updated in place; a resample makes new ones. `plain=True` runs every
    kernel's plain version (checks)."""
    P = pf.n_particles
    Pl = local_count(pf, mesh)
    lo = mesh.rank * Pl
    pf_local = dataclasses.replace(pf, n_particles=Pl)
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
        noise = noise[lo : lo + Pl] * _noise_scale(pf, dev)
    log_w = state.log_w
    scores = torch.full((Pl,), -1.0, dtype=torch.float32, device=dev)
    if do_refine:
        sharded_step.refines += 1
        priors = se2.compose(state.poses, delta[None, :] + noise)
        poses, scores = _refine_all(
            state.logodds, ranges, priors, cfg, pf_local, plain=plain
        )
        log_w, n_eff = _global_log_normalize(
            log_w + pf.weight_sharpness * scores, mesh)
        since_m = torch.zeros_like(since_m)
    elif boot:
        poses = se2.compose(state.poses, delta[None, :] + noise)
    else:
        poses = se2.compose(state.poses, delta[None, :])
    if n_eff is None:
        _, n_eff = _global_log_normalize(log_w, mesh)

    logodds = state.logodds
    if do_update:
        sharded_step.updates += 1
        _update_all(logodds, poses, ranges, cfg, pf_local, plain=plain)
        since = torch.zeros_like(since)

    best_pose, best_score = _best(log_w, poses, scores, mesh)
    n_eff_carry = n_eff
    if do_refine:
        sharded_step.host_syncs += 1
        if bool(n_eff < pf.resample_threshold * P):
            sharded_step.resamples += 1
            if u is None:
                u = torch.rand((), generator=generator, device=dev)
            both = mesh.all_gather(
                torch.cat([log_w[:, None], poses], dim=1), tiled=True)
            ancestors = systematic_ancestors(both[:, 0].contiguous(), u)
            want = ancestors[lo : lo + Pl]
            poses = both.index_select(0, want.to(torch.int64))[:, 1:]
            logodds, _ = ring_exchange(logodds, want, mesh, plain=plain)
            log_w = torch.full_like(
                log_w, -float(np.log(np.float32(P), dtype=np.float32))
            )
            n_eff_carry = torch.full_like(n_eff, float(P))

    new_state = PFState(
        logodds, poses.contiguous(), log_w, odom, state.dist + step_len,
        since, since_m,
    )
    return new_state, (best_pose, n_eff, best_score, n_eff_carry)


sharded_step.host_syncs = 0
sharded_step.refines = 0
sharded_step.updates = 0
sharded_step.resamples = 0


def sharded_light_chunk(state: PFState, odom_seg, cfg: FrontendConfig,
                        mesh: Mesh):
    """Dead reckoning over a run of scans where no stage fires (the
    counterpart of JAX's make_sharded_light_chunk): the maps are not
    touched and the weights do not change, so the best rank is resolved
    once for the whole run, by one all_gather of each rank's best weight
    packed with its best particle's poses. `odom_seg` [n, 3] on the
    device. Returns (state, best poses [n, 3]), the same on every rank;
    the scalar carry moves as sharded_step moves it."""
    b = torch.argmax(state.log_w).reshape(1)
    poses, prev = state.poses, state.prev_odom
    dist, su, sm = state.dist, state.since_update, state.since_match
    ratio = cfg.match_min_motion / max(cfg.match_min_rot, 1e-6)
    traj = []
    for o in odom_seg:
        delta = se2.between(prev, o)
        step_len = torch.hypot(delta[0], delta[1])
        rot_equiv = torch.abs(se2.wrap_angle(delta[2])) * ratio
        sm = sm + step_len + rot_equiv
        su = su + step_len
        dist = dist + step_len
        poses = se2.compose(poses, delta[None, :])
        traj.append(poses.index_select(0, b)[0])
        prev = o
    cand = torch.cat([state.log_w.index_select(0, b),
                      torch.stack(traj).reshape(-1)])
    cands = mesh.all_gather(cand)
    k = torch.argmax(cands[:, 0]).reshape(1)
    bp = cands.index_select(0, k)[0, 1:].reshape(-1, 3)
    return PFState(state.logodds, poses, state.log_w, prev, dist, su,
                   sm), bp


def best_map(state: PFState, mesh: Mesh):
    """The map of the globally best-weighted particle (the first of the
    largest weight), on every rank: one all_gather of each rank's best
    weight, then a broadcast from its owner."""
    b = int(torch.argmax(state.log_w))
    w = mesh.all_gather(state.log_w[b : b + 1].reshape(1))[:, 0]
    owner = int(torch.argmax(w))
    best = mesh.all_gather(torch.tensor([b], device=state.log_w.device))
    row = int(best[owner, 0])
    src = state.logodds[row] if mesh.rank == owner else torch.empty_like(
        state.logodds[0])
    return mesh.broadcast(src.contiguous(), owner)

