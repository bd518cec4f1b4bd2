"""Shared-anchor batched refine of every particle, port of
slam2d_tpu/pf/shared_refine.py.

The scan is common to all particles. With every particle's candidate
translations anchored on the map's cell lattice (its prior's cell center
plus integer cell offsets) and its rotations on one global theta grid, the
endpoint-splat image E_g of each theta depends on the scan alone, and all
particles are scored by one product:

    scores[p, (g, dr, dc)] = <S_p, shift_{dr,dc}(E_g)>
                           = (S [P, K] @ stack [G*R*C, K]^T)   K = win^2

S_p is particle p's likelihood field over the window centered on its
prior's cell (kernel: ops/field.py); the stack holds every shift of every
E_g (kernel: ops/stack.py); E is splatted in plain PyTorch, as the JAX
package does it in XLA. The product is a library GEMM in full float32: the
JAX package asks XLA for a float32 result of its bf16 operands, and bf16
values are exact in float32, so both operands are widened and TF32 is off.
The selection (motion prior, theta range mask, argmax, sub-cell and
sub-bin peak, keep-the-prior rule) follows the JAX function line by line.

Only the unpadded window frame of the JAX package's stack is ported: the
fused field kernel, which the port always runs, emits that frame.

The device-gated step passes its refine gate (a bool device tensor): the
field and stack kernels return at once when it is false, the splat's
zeros and the product's zeros are selected by `torch.where`, and the
product itself still runs (no GEMM here takes a gate).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from slam2d_tpu_torch.config import FrontendConfig, MatcherConfig, PFConfig
from slam2d_tpu_torch.core import se2
from slam2d_tpu_torch.core.numerics import highest_matmul_precision, inv_f32
from slam2d_tpu_torch.grid.occupancy import (
    cell_center_world,
    scan_endpoints_local,
    world_to_cell,
)
from slam2d_tpu_torch.grid.window import blur_halo_cells, scan_window_cells
from slam2d_tpu_torch.match.correlative import (
    gaussian_kernel_1d,
    splat_image,
    splat_inputs,
)
from slam2d_tpu_torch.ops import _build
from slam2d_tpu_torch.ops.field import window_field
from slam2d_tpu_torch.ops.stack import shift_stack


def _global_theta_grid(mcfg: MatcherConfig, pad: int):
    """(G, step): n_theta + 2*pad slots at the matcher's theta step."""
    if mcfg.n_theta <= 1:
        return 1 + 2 * pad, 0.0
    step = 2.0 * mcfg.search_theta / (mcfg.n_theta - 1)
    return mcfg.n_theta + 2 * pad, step


def aligned_origins(priors, gcfg, win: int):
    """Where each particle's scoring window lies, as the JAX package's
    aligned_window places it: the win x win window whose CENTER cell is
    the prior's cell, even at the map's edges. Returns its UNCLAMPED
    top-left cell [P, 2] int32 (row, col), which the field kernel
    (ops/field.py) reads from, and the anchor [P, 2]: the world xy of the
    prior's cell center."""
    center = world_to_cell(priors[:, :2], gcfg)
    return (center - win // 2).contiguous(), cell_center_world(center, gcfg)


def endpoint_splat(ranges, sensor, thetas, win: int, R: int, C: int,
                   res: float, cdtype, gate=None):
    """E [G, win, win] in `cdtype`: the bilinear four-corner splat of every
    valid beam endpoint of the scan rotated by each of `thetas`, placed so
    that the window's center cell center is the sensor, shifted by
    (-(R//2), -(C//2)) cells (ops/mxu_score.py:_endpoint_splat with
    _splat_inputs). A beam whose (R+1) x (C+1) patch leaves the window is
    dropped whole. The corner weights are rounded to `cdtype` first, as
    the JAX package's one-hot operands are, and summed in float32. Zeros
    where the bool device tensor `gate` is false."""
    pts_local, valid = scan_endpoints_local(ranges, sensor)
    pts = se2.rotate_points(thetas, pts_local[None, :, :])      # [G, B, 2]
    inv_res = inv_f32(res)
    pos_col = torch.where(valid[None, :], pts[..., 0] * inv_res + win // 2, 0.0)
    pos_row = torch.where(valid[None, :], pts[..., 1] * inv_res + win // 2, 0.0)
    r0, c0, fr, fc, ok = splat_inputs(
        (win, win), pos_row, pos_col, valid, R, C, bilinear=True
    )
    return splat_image(r0, c0, fr, fc, ok, (win, win), cdtype, gate=gate)


def endpoint_shift_stack(ranges, sensor, thetas, win: int, R: int, C: int,
                         res: float, cdtype, plain: bool = False, gate=None):
    """The scan-shared scorer weights [G*R*C, win*win] in `cdtype`:
    stack[g, dr*C + dc][h, w] = E_g[h - dr, w - dc], zero where the shift
    runs off the low edge, so <stack[g, l], S> scores the shift (dr, dc).
    Not to be read where the bool device tensor `gate` is false.
    `plain=True` runs the stack kernel's plain version (checks only)."""
    E = endpoint_splat(ranges, sensor, thetas, win, R, C, res, cdtype,
                       gate=gate)
    return shift_stack(E, R, C, plain=plain, gate=gate).reshape(
        thetas.shape[0] * R * C, win * win
    )


def _product_f32(a, b):
    """a @ b^T in full float32: TF32 off for the call."""
    with highest_matmul_precision():
        return a @ b.T


def shared_scores(grids, ranges, priors, cfg: FrontendConfig,
                  mcfg: MatcherConfig, pf: PFConfig, plain: bool = False,
                  gate=None):
    """Raw scores [P, G, R, C] of every particle's candidates, the anchors
    [P, 2] (world xy of each prior's cell center) and the global thetas
    [G]. The scores are zeros where the bool device tensor `gate` is
    false. `plain=True` runs every kernel's plain version (checks
    only)."""
    gcfg = cfg.grid
    res = gcfg.resolution
    P = grids.shape[0]
    win = scan_window_cells(gcfg, cfg.sensor, mcfg)
    r_fine = int(round(mcfg.search_xy / res))
    R = C = 2 * r_fine + 1
    G, dth_step = _global_theta_grid(mcfg, pf.refine_theta_pad)
    cdtype = torch.bfloat16 if mcfg.score_bf16 else torch.float32

    _, valid = scan_endpoints_local(ranges, cfg.sensor)
    denom = torch.clamp(valid.to(torch.float32).sum(), min=1.0)

    # the global theta grid, centered on the priors' circular mean heading
    # (a mean as XLA compiles it: the sum times float32(1 / P))
    inv_p = inv_f32(P)
    theta_ref = torch.atan2(
        torch.sin(priors[:, 2]).sum() * inv_p,
        torch.cos(priors[:, 2]).sum() * inv_p,
    )
    dthg = (
        torch.arange(G, dtype=torch.float32, device=grids.device)
        - (G - 1) / 2.0
    ) * float(np.float32(dth_step))
    thetas = theta_ref + dthg                                    # [G]

    stack = endpoint_shift_stack(
        ranges, cfg.sensor, thetas, win, R, C, res, cdtype, plain=plain,
        gate=gate,
    )
    origins, anchors = aligned_origins(priors, gcfg, win)        # [P, 2]
    thr = mcfg.free_threshold
    Sp = window_field(
        grids, origins, win,
        gaussian_kernel_1d(mcfg.sigma_m / res, blur_halo_cells(mcfg, res)),
        inv_sat=1.0 / mcfg.occ_evidence_sat,
        free_logit=math.log(thr / (1.0 - thr)),
        free_penalty=mcfg.free_penalty, out_dtype=cdtype, gate=gate,
        plain=plain,
    )
    raw = _product_f32(
        Sp.reshape(P, win * win).to(torch.float32), stack.to(torch.float32)
    ) / denom
    return _build.gated(gate, raw, 0.0).reshape(P, G, R, C), anchors, thetas


def shared_refine(grids, ranges, priors, cfg: FrontendConfig,
                  mcfg: MatcherConfig, pf: PFConfig, plain: bool = False,
                  gate=None):
    """Batched refine of all particles against their own maps.

    `grids` [P, Hm, Wm] (float32 or bfloat16), `ranges` [B] (the shared
    scan), `priors` [P, 3] (the noisy odometry proposals), all on one
    device. Returns (poses [P, 3], scores [P]): each particle's refined
    pose (its prior where the best raw score is below mcfg.min_score or
    the chosen theta slot is outside its own theta range) and the raw
    field score at the chosen candidate (the weight's input). Nothing is
    read back to the host. Where the bool device tensor `gate` is false
    the kernels return at once and the result is not to be read (the
    device-gated step selects its prior). `plain=True` runs every kernel's
    plain version (checks only)."""
    res = cfg.grid.resolution
    P = grids.shape[0]
    raw, anchor_xy, thetas = shared_scores(
        grids, ranges, priors, cfg, mcfg, pf, plain=plain, gate=gate
    )
    _, G, R, C = raw.shape
    ra, ca = R // 2, C // 2
    _, dth_step = _global_theta_grid(mcfg, pf.refine_theta_pad)
    dev = raw.device

    # motion prior + per-particle theta-range mask
    off_r = (torch.arange(R, dtype=torch.float32, device=dev) - ra) * res
    off_c = (torch.arange(C, dtype=torch.float32, device=dev) - ca) * res
    dx = anchor_xy[:, 0:1] + off_c[None, :] - priors[:, 0:1]     # [P, C]
    dy = anchor_xy[:, 1:2] + off_r[None, :] - priors[:, 1:2]     # [P, R]
    dth = se2.wrap_angle(thetas[None, :] - priors[:, 2:3])       # [P, G]
    pen = (
        mcfg.prior_theta_weight * (dth * dth)[:, :, None, None]
        + mcfg.prior_xy_weight * (dy * dy)[:, None, :, None]
        + mcfg.prior_xy_weight * (dx * dx)[:, None, None, :]
    )
    in_range = torch.abs(dth) <= mcfg.search_theta + 0.5 * dth_step + 1e-6
    sf = raw - pen - torch.where(in_range, 0.0, 1e9)[:, :, None, None]

    # argmax (the first maximum, as jnp.argmax) + quadratic sub-cell and
    # sub-bin peak (match_scan's semantics)
    sf_flat = sf.reshape(P, -1)
    flat = torch.argmax(sf_flat, dim=1)
    gi, ri, ci = flat // (R * C), (flat % (R * C)) // C, flat % C
    best_raw = raw.reshape(P, -1).gather(1, flat[:, None])[:, 0]

    def subpeak(along):
        idx = [gi, ri, ci]
        n = (G, R, C)[along]
        i0 = torch.clamp(idx[along], 1, n - 2)

        def at(shift):
            sl = list(idx)
            # out-of-range reads clamp, as XLA's gather does
            sl[along] = torch.clamp(i0 + shift, 0, n - 1)
            f = (sl[0] * R + sl[1]) * C + sl[2]
            return sf_flat.gather(1, f[:, None])[:, 0]

        vm, v0, vp = at(-1), at(0), at(1)
        den = vm - 2.0 * v0 + vp
        d = torch.where(torch.abs(den) > 1e-9, 0.5 * (vm - vp) / den, 0.0)
        d = torch.clamp(d, -0.5, 0.5)
        # borders AND -1e9-masked theta neighbours invalidate the quadratic
        ok = (
            (idx[along] >= 1) & (idx[along] <= n - 2) & (vm > -1e8)
            & (vp > -1e8)
        )
        return torch.where(ok, d, 0.0)

    sub_t = subpeak(0) * float(np.float32(dth_step))
    sub_r = subpeak(1) * res
    sub_c = subpeak(2) * res
    poses = torch.stack(
        [
            anchor_xy[:, 0] + (ci.to(torch.float32) - ca) * res + sub_c,
            anchor_xy[:, 1] + (ri.to(torch.float32) - ra) * res + sub_r,
            se2.wrap_angle(thetas[gi] + sub_t),
        ],
        dim=1,
    )
    # keep the prior when the best raw score is weak OR the chosen slot is
    # outside the particle's own theta range (a heading that drifted past
    # every padded slot masks all candidates; the argmax is then not
    # trusted)
    in_range_best = in_range.gather(1, gi[:, None])[:, 0]
    keep = (best_raw >= mcfg.min_score) & in_range_best
    poses = torch.where(keep[:, None], poses, priors)
    return poses, best_raw
