"""Correlative scan matching over a two-level grid (coarse max-pool, fine
bilinear), port of slam2d_tpu/match/correlative.py.

The search space S is a likelihood field: clipped occupancy evidence
blurred with a peak-normalized Gaussian, minus a penalty in known-free
space (ops/search_space.py). The coarse level is a max-pool of S. Every
(theta, drow, dcol) candidate is scored in one kernel launch per level,
by one of two scorers (`resolve_score_impl`): the gather scorer
(ops/score.py, the frontend's) or the correlation scorer "cmx"
(`score_cmx`: an endpoint-splat image per theta, correlated with S by
ops/corr.py; the per-particle refine's). `match_scan` matches one scan
against one map; `match_scans` matches it for a batch of particles, each
against its own search space, with one scorer launch per pass;
`peak_uniqueness` scores a match's coarse window for its peak margin.
Everything stays on the tensors' device; nothing here reads a value back
to the host.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from slam2d_tpu_torch.config import GridConfig, MatcherConfig, SensorConfig
from slam2d_tpu_torch.core import se2
from slam2d_tpu_torch.core.numerics import inv_f32
from slam2d_tpu_torch.grid.occupancy import scan_endpoints_local
from slam2d_tpu_torch.grid.window import blur_halo_cells
from slam2d_tpu_torch.ops import _build
from slam2d_tpu_torch.ops.corr import corr_scores
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
    """Conservative (max-pool) coarse search space of S [..., H, W].
    Non-divisible shapes are padded with a large negative value (never
    becomes the argmax)."""
    H, W = S.shape[-2:]
    ph = (-H) % factor
    pw = (-W) % factor
    if ph or pw:
        S = torch.nn.functional.pad(S, (0, pw, 0, ph), value=-1e9)
        H, W = S.shape[-2:]
    return S.reshape(
        *S.shape[:-2], H // factor, factor, W // factor, factor
    ).amax(dim=(-3, -1))


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


def resolve_score_impl(impl: str) -> str:
    """MatcherConfig.score_impl resolved with the accelerator's choices:
    "auto" (the frontend's single match) is the gather scorer, kernel 2;
    "auto_refine" (the per-particle refine) is "cmx", kernel 5. "pallas"
    scores as "gather" does; "emx" is "cmx"'s function with the search
    space rounded to the splat's dtype (the JAX package's HBM shift-stack
    form of it). "mxu" and "mxu_int8" are one-hot matmul forms of the
    gather scorer that only the TPU needed, and raise."""
    if impl in ("auto", "gather", "pallas"):
        return "gather"
    if impl == "auto_refine":
        return "cmx"
    if impl in ("cmx", "emx"):
        return impl
    if impl in ("mxu", "mxu_int8"):
        raise NotImplementedError(
            f"score_impl={impl!r} is a TPU workaround (one-hot matmuls in "
            "place of gathers) and is not ported: use 'gather' or 'cmx'"
        )
    raise ValueError(f"unknown score_impl {impl!r}")


def splat_inputs(shape, pos_row, pos_col, valid, R: int, C: int,
                 bilinear: bool):
    """(r0, c0, fr, fc, ok) of the correlation scorer, each [..., B]: a
    beam's top-left corner cell of its splat shifted by (-(R//2), -(C//2))
    and clipped into the window, its fractional offsets (0 for a rounded
    pass), and whether the beam is valid and its (R+1) x (C+1) patch lies
    inside the window (a beam that leaves it is dropped for every offset;
    ops/mxu_score.py:_splat_inputs)."""
    H, W = shape
    ra, ca = R // 2, C // 2
    if bilinear:
        r0f, c0f = torch.floor(pos_row), torch.floor(pos_col)
        fr, fc = pos_row - r0f, pos_col - c0f
    else:
        r0f, c0f = torch.round(pos_row), torch.round(pos_col)
        fr, fc = torch.zeros_like(pos_row), torch.zeros_like(pos_col)
    r0 = r0f.to(torch.int64) - ra
    c0 = c0f.to(torch.int64) - ca
    ok = (
        (r0 >= 0) & (r0 <= H - (R + 1)) & (c0 >= 0) & (c0 <= W - (C + 1))
        & valid
    )
    r0 = torch.clamp(r0, 0, H - (R + 1))
    c0 = torch.clamp(c0, 0, W - (C + 1))
    return r0, c0, fr, fc, ok


def splat_image(r0, c0, fr, fc, ok, shape, cdtype, gate=None):
    """E [..., H, W] in `cdtype`: the bilinear four-corner splat of every
    beam of `splat_inputs` (leading axes [..., B]). The corner weights are
    rounded to `cdtype` first, as the JAX package's one-hot operands are,
    multiplied and summed in float32, and rounded to `cdtype` once
    (ops/mxu_score.py:_endpoint_splat). The splat always runs (an
    index_put_, no kernel); where the bool device tensor `gate` is false,
    zeros are selected in its place."""
    H, W = shape
    lead = r0.shape[:-1]
    n = math.prod(lead)
    okf = ok.to(torch.float32)

    def rnd(w):
        return w.to(cdtype).to(torch.float32)

    wr = (rnd((1.0 - fr) * okf), rnd(fr * okf))
    wc = (rnd(1.0 - fc), rnd(fc))
    base = (
        torch.arange(n, device=r0.device).reshape(*lead, 1) * (H * W)
    )
    # [..., B, 4]: each beam's four corners, so that the sum at a cell runs
    # over the beams in order (a beam reaches a cell by one corner)
    idx = torch.stack(
        [base + (r0 + i) * W + (c0 + j) for i in (0, 1) for j in (0, 1)],
        dim=-1,
    )
    val = torch.stack([wr[i] * wc[j] for i in (0, 1) for j in (0, 1)], dim=-1)
    E = torch.zeros(n * H * W, dtype=torch.float32, device=r0.device)
    E.index_put_((idx.reshape(-1),), val.reshape(-1), accumulate=True)
    return _build.gated(gate, E.reshape(*lead, H, W).to(cdtype), 0.0)


def score_cmx(S, pos_row, pos_col, valid, R: int, C: int, bilinear: bool,
              use_bf16: bool = True, emx: bool = False, plain: bool = False,
              gate=None):
    """Summed (not yet averaged) scores [P, T, R, C] of the correlation
    scorer for a batch of search spaces S [P, H, W] float32 and endpoint
    positions [P, T, B]: score[p, t, dr, dc] = <E[p, t], S[p] shifted by
    (dr, dc)>, with E the beams' splat (`splat_image`, bf16 weights when
    `use_bf16`) and S zero-padded on its high sides (kernel 5,
    ops/corr.py; ops/mxu_score.py:score_offsets_cmx). `emx` rounds S to
    the splat's dtype first, as the JAX package's emx form does. `gate` (a
    bool device tensor) zeroes the splat and lets the kernel return at
    once when it is false; the scores are then not to be read.
    `plain=True` runs the kernel's plain version (checks only)."""
    P, H, W = S.shape
    T = pos_row.shape[1]
    cdtype = torch.bfloat16 if use_bf16 else torch.float32
    r0, c0, fr, fc, ok = splat_inputs(
        (H, W), pos_row, pos_col, valid, R, C, bilinear
    )
    E = splat_image(r0, c0, fr, fc, ok, (H, W), cdtype, gate=gate)
    if emx:
        S = S.to(cdtype).to(torch.float32)
    Sp = torch.nn.functional.pad(S, (0, C, 0, R)).contiguous()
    return corr_scores(E, Sp, R, C, plain=plain, gate=gate).reshape(
        P, T, R, C)


def score_offsets(
    S, prior_pose, pts_local, valid, dthetas, radius: int, cell_size: float,
    origin_xy, bilinear: bool = False, plain: bool = False,
    impl: str = "gather", use_bf16: bool = True, gate=None,
):
    """Score every (dtheta, drow, dcol) candidate around prior_pose, for
    drow, dcol in [-radius, radius] — the JAX package's score_offsets with
    symmetric offset ranges and a resolved `impl` ("gather", "cmx",
    "emx"; see `resolve_score_impl`).

    A candidate pose is prior ⊞ (dcol*cell, drow*cell, dtheta) in the WORLD
    frame. Score = mean over valid beams of S at the beam endpoints; with
    `bilinear` the field is sampled at the fractional endpoint position.
    The gather scorer masks each tap outside S on its own; the correlation
    scorer drops a beam whose patch leaves S. Returns
    [T, 2*radius+1, 2*radius+1] float32 scores. `gate` (a bool device
    tensor) lets the scorer's kernel (ops/score.py, ops/corr.py) return at
    once when it is false; the scores are then meaningless.
    """
    pos_row, pos_col = endpoint_positions(
        prior_pose, pts_local, valid, dthetas, cell_size, origin_xy
    )
    if impl == "gather":
        return score_window(
            S, pos_row, pos_col, valid, radius, bilinear, plain=plain,
            gate=gate,
        )
    n = 2 * radius + 1
    denom = torch.clamp(valid.to(torch.float32).sum(), min=1.0)
    return score_cmx(
        S[None], pos_row[None], pos_col[None], valid, n, n, bilinear,
        use_bf16=use_bf16, emx=impl == "emx", plain=plain, gate=gate,
    )[0] / denom


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


def peak_uniqueness(
    logodds, ranges, prior_pose, gcfg: GridConfig, mcfg: MatcherConfig,
    sensor: SensorConfig, excl_m: float = 0.5, search_space=None,
    origin_xy=None, plain: bool = False,
):
    """Peak-dominance margin of a match, a 0-d tensor on the input's device.

    Scores the coarse search window around prior_pose (the scorer of
    match_scan's coarse pass) and returns best - second_best, where
    second_best is the best score whose translation lies more than
    ceil(excl_m / coarse cell) coarse cells from the argmax along a
    row or a column, at any theta. Aliased matches (corridors, lattices)
    show several near-equal peaks and a small margin; unique ones a large
    one. `search_space` and `origin_xy` as for match_scan."""
    impl = resolve_score_impl(mcfg.score_impl)
    S = (
        build_search_space(logodds, mcfg, gcfg.resolution, plain=plain)
        if search_space is None
        else search_space
    )
    f = mcfg.coarse_factor
    pts_local, valid = scan_endpoints_local(ranges, sensor)
    origin = (
        (gcfg.origin_x, gcfg.origin_y) if origin_xy is None else origin_xy
    )
    r_coarse = int(math.ceil(int(round(mcfg.search_xy / gcfg.resolution)) / f))
    sc = score_offsets(
        coarse_space(S, f), prior_pose, pts_local, valid,
        _theta_table(mcfg, prior_pose.device), r_coarse, gcfg.resolution * f,
        origin, plain=plain, impl=impl, use_bf16=mcfg.score_bf16,
    )
    t, r, c = _argmax3(sc)
    best = _take(sc, t, r, c)
    excl = int(math.ceil(excl_m / (gcfg.resolution * f)))
    # |off[i] - off[r]| = |i - r| on the window's own offsets
    idx = torch.arange(2 * r_coarse + 1, device=sc.device)
    far = (
        (torch.abs(idx[None, :, None] - r) > excl)
        | (torch.abs(idx[None, None, :] - c) > excl)
    )
    second = torch.where(far, sc, -torch.inf).amax()
    return best - second


def match_scan(
    logodds, ranges, prior_pose, gcfg: GridConfig, mcfg: MatcherConfig,
    sensor: SensorConfig, search_space=None, origin_xy=None,
    plain: bool = False, gate=None,
):
    """Coarse-to-fine correlative match of one scan against the grid.

    Returns (pose [3], score scalar) as tensors on the input's device. A
    Gaussian motion-model penalty regularizes the argmax toward the prior;
    if the best fine score is below mcfg.min_score the prior is returned.
    `origin_xy` (host floats, or a float32 [2] tensor on the device) is
    the world origin of `search_space` when it is a window of the map.
    mcfg.score_impl picks the scorer (`resolve_score_impl`). With `gate`
    (a bool device tensor; the frontend step's motion gate) the scorer's
    kernels return at once when it is false, and the result is
    meaningless: the caller selects the prior instead.
    """
    dev = prior_pose.device
    impl = resolve_score_impl(mcfg.score_impl)
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
            plain=plain, impl=impl, use_bf16=mcfg.score_bf16, gate=gate,
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
        origin, bilinear=True, plain=plain, impl=impl,
        use_bf16=mcfg.score_bf16, gate=gate,
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


def endpoint_positions_batched(priors, pts_local, valid, dthetas,
                               cell_size: float, origin):
    """`endpoint_positions` for a batch: priors [P, 3], rotation candidates
    dthetas [P, T], window origins `origin` [P, 2] (x, y) tensors.
    Returns (pos_row, pos_col) [P, T, B]."""
    theta = priors[:, 2:3] + dthetas                                 # [P, T]
    pts = se2.rotate_points(theta, pts_local[None, None, :, :])      # [P,T,B,2]
    inv_cell = inv_f32(cell_size)
    ox, oy = origin[:, 0, None, None], origin[:, 1, None, None]
    pos_col = (pts[..., 0] + priors[:, 0, None, None] - ox) * inv_cell - 0.5
    pos_row = (pts[..., 1] + priors[:, 1, None, None] - oy) * inv_cell - 0.5
    pos_col = torch.where(valid, pos_col, 0.0)
    pos_row = torch.where(valid, pos_row, 0.0)
    return pos_row, pos_col


def _pick(x, idx):
    """x[p, idx[p]] for x [P, N] and integer idx [P] (clamped into range,
    as XLA's gather clamps)."""
    i = torch.clamp(idx, 0, x.shape[1] - 1).to(torch.int64)
    return x.gather(1, i[:, None])[:, 0]


def match_scans(
    S, origin, ranges, priors, gcfg: GridConfig, mcfg: MatcherConfig,
    sensor: SensorConfig, plain: bool = False, gate=None,
):
    """`match_scan` for a batch of particles, each against its own search
    space, with one scorer launch per pass for all of them (the JAX
    package's vmap of match_scan).

    S [P, H, W] float32 search spaces with world origins `origin` [P, 2]
    (x, y); `ranges` [B] the shared scan; `priors` [P, 3]. Returns (poses
    [P, 3], scores [P]) on the tensors' device: the coarse pass (when the
    translation window exceeds one fine pass), the fine_theta_bins slice
    of the thetas around each coarse winner, the bilinear fine pass, the
    motion penalty, the first maximum, the quadratic sub-cell and sub-bin
    peak and the keep-the-prior rule of `match_scan`, per particle. The
    batch is scored by the correlation scorer (mcfg.score_impl resolving
    to "cmx" or "emx"); "gather" (and "pallas"), whose scorer takes one
    search space a launch (kernel 2), runs `match_scan` particle by
    particle, the function of the JAX package's vmapped gather match.
    Nothing is read back to the host. `gate` (a bool device tensor) lets
    the scorer's kernels return at once when it is false; the results are
    then not to be read."""
    impl = resolve_score_impl(mcfg.score_impl)
    if impl == "gather":
        out = [
            match_scan(S[p], ranges, priors[p], gcfg, mcfg, sensor,
                       search_space=S[p], origin_xy=origin[p], plain=plain,
                       gate=gate)
            for p in range(priors.shape[0])
        ]
        return (torch.stack([o[0] for o in out]),
                torch.stack([o[1] for o in out]))
    dev = priors.device
    P = priors.shape[0]
    f = mcfg.coarse_factor
    pts_local, valid = scan_endpoints_local(ranges, sensor)
    denom = torch.clamp(valid.to(torch.float32).sum(), min=1.0)
    dthetas = _theta_table(mcfg, dev)
    T_th = dthetas.shape[0]

    def scores(S_, prior, dth, radius, cell, bilinear):
        """[P, T, n, n] mean scores; dth [P, T]."""
        pos_row, pos_col = endpoint_positions_batched(
            prior, pts_local, valid, dth, cell, origin
        )
        n = 2 * radius + 1
        return score_cmx(
            S_, pos_row, pos_col, valid, n, n, bilinear,
            use_bf16=mcfg.score_bf16, emx=impl == "emx", plain=plain,
            gate=gate,
        ) / denom

    def penalty(dx_m, dy_m, dth):
        """[P, T, R, C] motion-prior penalty; dx_m, dy_m [P, n], dth [P, T]."""
        return (
            mcfg.prior_theta_weight * (dth**2)[:, :, None, None]
            + mcfg.prior_xy_weight * (dy_m**2)[:, None, :, None]
            + mcfg.prior_xy_weight * (dx_m**2)[:, None, None, :]
        )

    def argmax3(sc):
        n_t, n_r, n_c = sc.shape[1:]
        flat = torch.argmax(sc.reshape(P, -1), dim=1)
        return flat // (n_r * n_c), (flat % (n_r * n_c)) // n_c, flat % n_c

    r_fine = int(round(mcfg.search_xy / gcfg.resolution))
    dth_all = dthetas[None, :].expand(P, T_th)
    zero = torch.zeros(P, dtype=torch.float32, device=dev)
    if r_fine <= f:
        coarse_dx = coarse_dy = zero
        prior2 = priors
        r_pass = r_fine
        dth_fine = dth_all
    else:
        r_coarse = int(math.ceil(r_fine / f))
        cs = gcfg.resolution * f
        sc = scores(
            coarse_space(S, f), priors, dth_all, r_coarse, cs, False
        )
        off_m = torch.arange(
            -r_coarse, r_coarse + 1, dtype=torch.int32, device=dev
        ).to(torch.float32) * cs
        off_p = off_m[None, :].expand(P, -1)
        sc = sc - penalty(off_p, off_p, dth_all)
        tc, rc, cc = argmax3(sc)
        coarse_dx = off_m[cc]
        coarse_dy = off_m[rc]
        prior2 = torch.stack(
            [priors[:, 0] + coarse_dx, priors[:, 1] + coarse_dy, priors[:, 2]],
            dim=1,
        )
        r_pass = f
        ftb = mcfg.fine_theta_bins
        if 0 <= ftb and 2 * ftb + 1 < T_th:
            nft = 2 * ftb + 1
            t0 = torch.clamp(tc - ftb, 0, T_th - nft)
            dth_fine = dthetas[t0[:, None] + torch.arange(nft, device=dev)]
        else:
            dth_fine = dth_all
    sf = scores(S, prior2, dth_fine, r_pass, gcfg.resolution, True)
    fine_m = torch.arange(
        -r_pass, r_pass + 1, dtype=torch.int32, device=dev
    ).to(torch.float32) * gcfg.resolution
    sf_raw = sf
    sf = sf - penalty(
        coarse_dx[:, None] + fine_m, coarse_dy[:, None] + fine_m, dth_fine
    )
    shape = sf.shape[1:]
    tf_, rf, cf = argmax3(sf)
    sf_flat = sf.reshape(P, -1)

    def flat_at(t, r, c):
        return (t * shape[1] + r) * shape[2] + c

    best = _pick(sf_raw.reshape(P, -1), flat_at(tf_, rf, cf))

    def subpeak(along):
        """1-D quadratic refinement of each particle's peak along one axis."""
        at = [tf_, rf, cf]
        n = shape[along]
        i0 = torch.clamp(at[along], 1, n - 2)
        vals = []
        for shift in (-1, 0, 1):
            sl = list(at)
            sl[along] = torch.clamp(i0 + shift, 0, n - 1)
            vals.append(_pick(sf_flat, flat_at(*sl)))
        vm, v0, vp = vals
        den = vm - 2.0 * v0 + vp
        d = torch.where(torch.abs(den) > 1e-9, 0.5 * (vm - vp) / den, 0.0)
        d = torch.clamp(d, -0.5, 0.5)
        # only valid if the argmax wasn't clamped at the window border
        return torch.where((at[along] >= 1) & (at[along] <= n - 2), d, 0.0)

    dth_step = float(2 * mcfg.search_theta / max(mcfg.n_theta - 1, 1))
    sub_t = subpeak(0) * dth_step
    sub_r = subpeak(1) * gcfg.resolution
    sub_c = subpeak(2) * gcfg.resolution
    poses = torch.stack(
        [
            prior2[:, 0] + fine_m[cf] + sub_c,
            prior2[:, 1] + fine_m[rf] + sub_r,
            se2.wrap_angle(priors[:, 2] + _pick(dth_fine, tf_) + sub_t),
        ],
        dim=1,
    )
    poses = torch.where((best >= mcfg.min_score)[:, None], poses, priors)
    return poses, best

