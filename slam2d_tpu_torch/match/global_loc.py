"""Global relocalization ("kidnapped robot"), port of
slam2d_tpu/match/global_loc.py: find the robot's pose in a prebuilt map
with NO prior, by scoring one scan over EVERY pose.

For a fixed heading theta, the correlative score over all translations is
a full-map cross-correlation between the search space S and the scan's
endpoint-splat image E_theta:

    score(v, theta) = sum_i S[v + e_i(theta)] = (S ★ E_theta)[v - center]

so the (x, y) sweep of one heading is two FFTs (torch.fft) and a product.
The full-circle heading grid (default 72 x 5 deg) is swept in chunks of
`theta_chunk` headings, with a running maximum and first-index argmax in
place of the whole [n_theta, Hp, Wp] volume (the maximum is exact, so the
result is the same); the winner seeds `match_scan` for a sub-cell,
sub-step refinement.

Border handling as in the JAX package: S is zero-padded by the sensor's
max range (rounded up to a multiple of 128 cells, which sets the
circular margin geometry), making the correlation linear for every
in-map robot cell, and displacements whose robot cell lies outside the
map are masked out; `pad_border=False` sweeps the cheaper wrapping
correlation. The endpoint splat is an `index_put_` with accumulation: on
a CUDA device its float sums are added in no fixed order.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from slam2d_tpu_torch.config import GridConfig, MatcherConfig, SensorConfig
from slam2d_tpu_torch.core.numerics import inv_f32
from slam2d_tpu_torch.grid.occupancy import scan_endpoints_local
from slam2d_tpu_torch.match.correlative import build_search_space, match_scan

N_THETA = 72  # global_localize's full-circle headings (5 deg)


def _endpoint_image(pts, valid, theta, H, W, resolution):
    """Bilinear endpoint splat around the image CENTER cell: [H, W] for a
    0-d `theta`, [n, H, W] for `theta` [n]. The four corners are added
    corner by corner, each over the beams in order, as the JAX package's
    four scatter-adds do."""
    th = theta.reshape(-1, 1)
    n = th.shape[0]
    c, s = torch.cos(th), torch.sin(th)
    inv = inv_f32(resolution)  # XLA's form of the division by resolution
    ex = (c * pts[:, 0] - s * pts[:, 1]) * inv + (W // 2)
    ey = (s * pts[:, 0] + c * pts[:, 1]) * inv + (H // 2)
    # invalid beams carry NaN coordinates; their weight is 0 but
    # 0 * NaN = NaN would poison the whole splat
    ex = torch.where(valid, ex, 0.0)
    ey = torch.where(valid, ey, 0.0)
    x0 = torch.floor(ex).to(torch.int64)
    y0 = torch.floor(ey).to(torch.int64)
    fx = ex - x0.to(torch.float32)
    fy = ey - y0.to(torch.float32)
    w = valid.to(torch.float32)
    base = torch.arange(n, device=pts.device)[:, None] * (H * W)
    idx, val = [], []
    for dy, dx, wt in (
        (0, 0, (1 - fy) * (1 - fx)),
        (0, 1, (1 - fy) * fx),
        (1, 0, fy * (1 - fx)),
        (1, 1, fy * fx),
    ):
        yy = torch.clamp(y0 + dy, 0, H - 1)
        xx = torch.clamp(x0 + dx, 0, W - 1)
        idx.append(base + yy * W + xx)
        val.append(w * wt)
    # [4, n, B] -> one accumulation, corner-major
    idx = torch.stack(idx).transpose(0, 1).reshape(-1)
    val = torch.stack(val).transpose(0, 1).reshape(-1)
    img = torch.zeros(n * H * W, dtype=torch.float32, device=pts.device)
    img.index_put_((idx,), val, accumulate=True)
    return img.reshape(H, W) if theta.dim() == 0 else img.reshape(n, H, W)


def _global_sweep(S, ranges, gcfg: GridConfig, sensor: SensorConfig,
                  n_theta: int, theta_chunk: int, pad: int = 0):
    """(coarse pose [3], best score, peak-uniqueness margin), 0-d tensors
    on S's device; nothing is read back to the host."""
    dev = S.device
    H, W = S.shape
    if pad:
        # zero band: endpoints reach at most `pad` cells from the robot,
        # and the band absorbs both directions of wrap
        Hp = -(-(H + 2 * pad) // 128) * 128
        Wp = -(-(W + 2 * pad) // 128) * 128
        S_use = torch.zeros((Hp, Wp), dtype=torch.float32, device=dev)
        S_use[:H, :W] = S
    else:
        Hp, Wp = H, W
        S_use = S.to(torch.float32)
    pts, valid = scan_endpoints_local(ranges, sensor)
    denom = torch.clamp(valid.to(torch.float32).sum(), min=1.0)
    FS = torch.fft.rfft2(S_use)
    thetas = (
        torch.arange(n_theta, dtype=torch.float32, device=dev)
        * np.float32(2.0 * np.pi / n_theta) - np.float32(np.pi)
    )
    # displacement d -> robot cell v = d + center (mod padded dims); only
    # robot cells INSIDE the original map are poses
    rr = torch.arange(Hp, device=dev)
    cc = torch.arange(Wp, device=dev)
    in_map = (
        (torch.remainder(rr + Hp // 2, Hp) < H)[:, None]
        & (torch.remainder(cc + Wp // 2, Wp) < W)[None, :]
    )
    best = torch.full((), -torch.inf, device=dev)
    best_flat = torch.zeros((), dtype=torch.int64, device=dev)
    over_th = torch.full((Hp, Wp), -torch.inf, device=dev)
    for t0 in range(0, n_theta, theta_chunk):
        E = _endpoint_image(pts, valid, thetas[t0 : t0 + theta_chunk], Hp, Wp,
                            gcfg.resolution)
        # correlation theorem: corr[d] = IFFT(conj(FFT(E)) * FFT(S))[d]
        corr = torch.fft.irfft2(torch.conj(torch.fft.rfft2(E)) * FS,
                                s=(Hp, Wp)) / denom
        corr = torch.where(in_map, corr, -torch.inf)
        over_th = torch.maximum(over_th, corr.amax(dim=0))
        flat = torch.argmax(corr.reshape(-1))
        val = corr.reshape(-1).index_select(0, flat.reshape(1)).reshape(())
        # strictly greater: the first maximum, theta-major, wins ties
        better = val > best
        best = torch.where(better, val, best)
        best_flat = torch.where(better, flat + t0 * Hp * Wp, best_flat)
    ti = best_flat // (Hp * Wp)
    d = best_flat % (Hp * Wp)
    dr, dc = d // Wp, d % Wp
    # peak-uniqueness margin: best minus the best OUTSIDE a ~1 m box around
    # the winner (any heading), in CIRCULAR distance on the FFT domain
    ex = max(int(round(1.0 / gcfg.resolution)), 2)
    ar = torch.abs(rr - dr)
    ac = torch.abs(cc - dc)
    near = (
        (torch.minimum(ar, Hp - ar) <= ex)[:, None]
        & (torch.minimum(ac, Wp - ac) <= ex)[None, :]
    )
    second = torch.where(near, -torch.inf, over_th).amax()
    margin = best - torch.clamp(second, min=-1e9)
    vr = torch.remainder(dr + Hp // 2, Hp).to(torch.float32)
    vc = torch.remainder(dc + Wp // 2, Wp).to(torch.float32)
    x = gcfg.origin_x + (vc + 0.5) * gcfg.resolution
    y = gcfg.origin_y + (vr + 0.5) * gcfg.resolution
    theta = thetas.index_select(0, ti.reshape(1)).reshape(())
    return torch.stack([x, y, theta]), best, margin


def global_localize(
    logodds,
    ranges,
    gcfg: GridConfig,
    mcfg: MatcherConfig,
    sensor: SensorConfig,
    n_theta: int = N_THETA,
    theta_chunk: int = 8,
    search_space=None,
    refine: bool = True,
    return_margin: bool = False,
    pad_border: bool = True,
    plain: bool = False,
    device=None,
):
    """Returns (pose [3], score) — or (pose, score, margin) with
    return_margin=True, where margin is the peak-uniqueness diagnostic
    (best score minus the best score outside ~1 m of the winner, any
    heading; near-zero under perceptual aliasing) — as tensors on the
    map's device.

    `logodds` [H, W] and `ranges` [B] are tensors, or numpy arrays that
    are copied to `device` (the card when None). `n_theta` full-circle
    headings are FFT-swept, `theta_chunk` at a time; the winner seeds a
    match_scan refinement over +-1 heading step and a few cells (no prior
    weight, min_score 0). refine=False returns the raw grid peak.
    `search_space` is S when it is already built (else one kernel 3
    launch); `pad_border` as in the module docstring. `plain=True` runs
    the kernels' plain versions (checks only)."""
    if n_theta % theta_chunk:
        raise ValueError(f"n_theta {n_theta} is no multiple of theta_chunk "
                         f"{theta_chunk}")
    if isinstance(logodds, torch.Tensor):
        dev = logodds.device
    else:
        dev = torch.device("cuda" if device is None else device)
        logodds = torch.as_tensor(np.asarray(logodds, np.float32), device=dev)
    if not isinstance(ranges, torch.Tensor):
        ranges = torch.as_tensor(np.asarray(ranges, np.float32), device=dev)
    S = (
        build_search_space(logodds, mcfg, gcfg.resolution, plain=plain)
        if search_space is None
        else search_space
    )
    pad = (
        int(np.ceil(sensor.max_range / gcfg.resolution)) + 2
        if pad_border else 0
    )
    coarse, score, margin = _global_sweep(
        S, ranges, gcfg, sensor, n_theta, theta_chunk, pad
    )
    if not refine:
        return (coarse, score, margin) if return_margin else (coarse, score)
    pose, score = match_scan(
        logodds, ranges, coarse, gcfg, refine_matcher(mcfg, gcfg, n_theta),
        sensor, search_space=S, plain=plain,
    )
    return (pose, score, margin) if return_margin else (pose, score)


def sweep_cell(pose, gcfg: GridConfig, n_theta: int = N_THETA):
    """(row, col, heading index) of a coarse sweep pose (`refine=False`):
    the map cell and the heading of `n_theta` that the sweep read it
    from."""
    return (round((float(pose[1]) - gcfg.origin_y) / gcfg.resolution - 0.5),
            round((float(pose[0]) - gcfg.origin_x) / gcfg.resolution - 0.5),
            round((float(pose[2]) + np.pi) / (2 * np.pi / n_theta)))


def refine_matcher(mcfg: MatcherConfig, gcfg: GridConfig,
                   n_theta: int = N_THETA) -> MatcherConfig:
    """The matcher of the sweep winner's refinement: +-1 heading step in 9
    candidates, max(2.5 cells, 0.15 m) of translation, no prior weight,
    min_score 0."""
    return dataclasses.replace(
        mcfg,
        search_xy=max(2.5 * gcfg.resolution, 0.15),
        search_theta=2.0 * np.pi / n_theta,
        n_theta=9,
        prior_xy_weight=0.0,
        prior_theta_weight=0.0,
        min_score=0.0,
    )
