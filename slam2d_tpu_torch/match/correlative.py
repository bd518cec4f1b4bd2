"""Correlative scan matching over a two-level grid (coarse max-pool, fine
bilinear), port of slam2d_tpu/match/correlative.py for the frontend.

The search space S is a likelihood field: clipped occupancy evidence
blurred with a peak-normalized Gaussian, minus a penalty in known-free
space (ops/search_space.py). The coarse level is a max-pool of S. Every
(theta, drow, dcol) candidate is scored in one kernel launch per level
(ops/score.py). Everything stays on the tensors' device; nothing here
reads a value back to the host.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from slam2d_tpu.config import GridConfig, MatcherConfig, SensorConfig
from slam2d_tpu_torch.core import se2
from slam2d_tpu_torch.core.numerics import inv_f32
from slam2d_tpu_torch.grid.occupancy import scan_endpoints_local
from slam2d_tpu_torch.grid.window import blur_halo_cells
from slam2d_tpu_torch.ops.score import score_window
from slam2d_tpu_torch.ops.search_space import search_space


def gaussian_kernel_1d(sigma: float, halfwidth: int) -> np.ndarray:
    x = np.arange(-halfwidth, halfwidth + 1, dtype=np.float32)
    k = np.exp(-0.5 * (x / max(sigma, 1e-6)) ** 2)
    return (k / k.max()).astype(np.float32)  # peak-normalized: S in [0, 1]


def build_search_space(
    logodds, mcfg: MatcherConfig, resolution: float, plain: bool = False
):
    """Blurred occupied-cell likelihood field, same shape as the grid, in
    [-free_penalty, 1] (see the JAX package for why free space scores
    negative). The blur halfwidth is blur_halo_cells, which the cached
    field's writeback trims."""
    taps = gaussian_kernel_1d(
        mcfg.sigma_m / resolution, blur_halo_cells(mcfg, resolution)
    )
    return search_space(
        logodds, taps, occ_sat=mcfg.occ_evidence_sat,
        free_threshold=mcfg.free_threshold, free_penalty=mcfg.free_penalty,
        plain=plain,
    )


def coarse_space(S, factor: int):
    """Conservative (max-pool) coarse search space. Non-divisible shapes
    are padded with a large negative value (never becomes the argmax)."""
    H, W = S.shape
    ph = (-H) % factor
    pw = (-W) % factor
    if ph or pw:
        S = torch.nn.functional.pad(S, (0, pw, 0, ph), value=-1e9)
        H, W = S.shape
    return S.reshape(H // factor, factor, W // factor, factor).amax(dim=(1, 3))


def _theta_offsets(mcfg: MatcherConfig) -> np.ndarray:
    """Rotation candidates; n_theta == 1 means 'no rotation search' ([0])."""
    if mcfg.n_theta <= 1:
        return np.zeros(1, np.float32)
    return np.linspace(
        -mcfg.search_theta, mcfg.search_theta, mcfg.n_theta
    ).astype(np.float32)


@functools.cache
def _theta_table(mcfg: MatcherConfig, device) -> torch.Tensor:
    """_theta_offsets on `device`, cached so a match copies nothing from
    the host. Callers must not write into it."""
    return torch.as_tensor(_theta_offsets(mcfg), device=device)


def endpoint_positions(
    prior_pose, pts_local, valid, dthetas, cell_size: float, origin_xy
):
    """Fractional cell-center (row, col) positions [T, B] of the beam
    endpoints for each rotation candidate, zeroed for invalid beams."""
    theta = prior_pose[2] + dthetas                          # [T]
    pts = se2.rotate_points(theta, pts_local[None, :, :])     # [T, B, 2]
    # invalid beams are force-zeroed: a NaN range would otherwise leak
    # through the bilinear weights (0 * NaN = NaN)
    inv_cell = inv_f32(cell_size)  # XLA's form of the division by cell_size
    pos_col = (pts[..., 0] + prior_pose[0] - origin_xy[0]) * inv_cell - 0.5
    pos_row = (pts[..., 1] + prior_pose[1] - origin_xy[1]) * inv_cell - 0.5
    pos_col = torch.where(valid[None, :], pos_col, 0.0)
    pos_row = torch.where(valid[None, :], pos_row, 0.0)
    return pos_row.contiguous(), pos_col.contiguous()


def score_offsets(
    S, prior_pose, pts_local, valid, dthetas, radius: int, cell_size: float,
    origin_xy, bilinear: bool = False, plain: bool = False,
):
    """Score every (dtheta, drow, dcol) candidate around prior_pose, for
    drow, dcol in [-radius, radius] — the JAX package's
    score_offsets(impl="gather") with symmetric offset ranges.

    A candidate pose is prior ⊞ (dcol*cell, drow*cell, dtheta) in the WORLD
    frame. Score = mean over valid beams of S at the beam endpoints; with
    `bilinear` the field is sampled at the fractional endpoint position.
    Returns [T, 2*radius+1, 2*radius+1] float32 scores.
    """
    pos_row, pos_col = endpoint_positions(
        prior_pose, pts_local, valid, dthetas, cell_size, origin_xy
    )
    return score_window(
        S, pos_row, pos_col, valid, radius, bilinear, plain=plain
    )


def _take(x, *idx):
    """x[idx] for 0-d integer index tensors, as a 0-d tensor. Indexing
    with a 0-d tensor would read it back to the host (PyTorch treats it as
    a Python int); a flat index_select keeps the lookup on the device."""
    flat = idx[0]
    for i, n in zip(idx[1:], x.shape[1:]):
        flat = flat * n + i
    return x.reshape(-1).index_select(0, flat.reshape(1)).reshape(())


def _argmax3(scores):
    """(t, r, c) index of the (first) max of a [T, R, C] tensor."""
    flat_idx = torch.argmax(scores.reshape(-1))
    T, R, C = scores.shape
    return flat_idx // (R * C), (flat_idx % (R * C)) // C, flat_idx % C


def match_scan(
    logodds, ranges, prior_pose, gcfg: GridConfig, mcfg: MatcherConfig,
    sensor: SensorConfig, search_space=None, origin_xy=None,
    plain: bool = False,
):
    """Coarse-to-fine correlative match of one scan against the grid.

    Returns (pose [3], score scalar) as tensors on the input's device. A
    Gaussian motion-model penalty regularizes the argmax toward the prior;
    if the best fine score is below mcfg.min_score the prior is returned.
    `origin_xy` (host floats) is the world origin of `search_space` when
    it is a window of the map. Only the frontend's scorer (the gather
    semantics, kernel 2) is ported: mcfg.score_impl is not read.
    """
    dev = prior_pose.device
    S = (
        build_search_space(logodds, mcfg, gcfg.resolution, plain=plain)
        if search_space is None
        else search_space
    )
    f = mcfg.coarse_factor
    Sc = coarse_space(S, f)
    pts_local, valid = scan_endpoints_local(ranges, sensor)
    origin = (
        (gcfg.origin_x, gcfg.origin_y) if origin_xy is None else origin_xy
    )
    dthetas = _theta_table(mcfg, dev)
    T_th = dthetas.shape[0]

    def penalty(dx_m, dy_m, dth):
        """Motion-prior penalty surface [T, R, C] from per-axis offsets."""
        return (
            mcfg.prior_theta_weight * (dth**2)[:, None, None]
            + mcfg.prior_xy_weight * (dy_m**2)[None, :, None]
            + mcfg.prior_xy_weight * (dx_m**2)[None, None, :]
        )

    # the whole translation window fits one fine pass: skip the pyramid
    r_fine = int(round(mcfg.search_xy / gcfg.resolution))
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    if r_fine <= f:
        coarse_dx = coarse_dy = zero
        prior2 = prior_pose
        r_pass = r_fine
        dth_fine = dthetas
    else:
        r_coarse = int(math.ceil(r_fine / f))
        cs = gcfg.resolution * f
        sc = score_offsets(
            Sc, prior_pose, pts_local, valid, dthetas, r_coarse, cs, origin,
            plain=plain,
        )
        off_m = torch.arange(
            -r_coarse, r_coarse + 1, dtype=torch.int32, device=dev
        ).to(torch.float32) * cs
        sc = sc - penalty(off_m, off_m, dthetas)
        tc, rc, cc = _argmax3(sc)
        coarse_dx = _take(off_m, cc)
        coarse_dy = _take(off_m, rc)
        prior2 = torch.stack(
            [prior_pose[0] + coarse_dx, prior_pose[1] + coarse_dy, prior_pose[2]]
        )
        # fine pass: +/- one coarse cell at full res, bilinear, over a
        # neighbourhood of the coarse theta winner (fine_theta_bins)
        r_pass = f
        ftb = mcfg.fine_theta_bins
        if 0 <= ftb and 2 * ftb + 1 < T_th:
            nft = 2 * ftb + 1
            t0 = torch.clamp(tc - ftb, 0, T_th - nft)
            dth_fine = dthetas[t0 + torch.arange(nft, device=dev)]
        else:
            dth_fine = dthetas
    sf = score_offsets(
        S, prior2, pts_local, valid, dth_fine, r_pass, gcfg.resolution,
        origin, bilinear=True, plain=plain,
    )
    fine_m = torch.arange(
        -r_pass, r_pass + 1, dtype=torch.int32, device=dev
    ).to(torch.float32) * gcfg.resolution
    sf_raw = sf
    sf = sf - penalty(coarse_dx + fine_m, coarse_dy + fine_m, dth_fine)
    tf_, rf, cf = _argmax3(sf)
    # the PENALIZED surface picks the pose; the RAW field value there is
    # the reported/gated match quality
    best = _take(sf_raw, tf_, rf, cf)

    def subpeak(idx, along):
        """1-D quadratic refinement of the peak along one axis of sf."""
        n = sf.shape[along]
        i0 = torch.clamp(idx, 1, n - 2)
        at = [tf_, rf, cf]
        sm, s0, sp = list(at), list(at), list(at)
        sm[along], s0[along], sp[along] = i0 - 1, i0, i0 + 1
        vm, v0, vp = _take(sf, *sm), _take(sf, *s0), _take(sf, *sp)
        denom = vm - 2.0 * v0 + vp
        d = torch.where(torch.abs(denom) > 1e-9, 0.5 * (vm - vp) / denom, 0.0)
        d = torch.clamp(d, -0.5, 0.5)
        # only valid if the argmax wasn't clamped at the window border
        return torch.where((idx >= 1) & (idx <= n - 2), d, 0.0)

    dth_step = float(2 * mcfg.search_theta / max(mcfg.n_theta - 1, 1))
    sub_t = subpeak(tf_, 0) * dth_step
    sub_r = subpeak(rf, 1) * gcfg.resolution
    sub_c = subpeak(cf, 2) * gcfg.resolution
    pose = torch.stack(
        [
            prior2[0] + _take(fine_m, cf) + sub_c,
            prior2[1] + _take(fine_m, rf) + sub_r,
            se2.wrap_angle(prior_pose[2] + _take(dth_fine, tf_) + sub_t),
        ]
    )
    pose = torch.where(best >= mcfg.min_score, pose, prior_pose)
    return pose, best
