"""Hybrid inverse-sensor-model log-odds update of a map window.

Kernel: csrc/update_hybrid.cu, the port of
slam2d_tpu/ops/pallas_update.py:_update_kernel, variant "hybrid". The
contract is `pallas_dense_update(..., variant="hybrid")`:

- a cell is FREE if some beam b has the cell's bearing within half a beam
  step of b's angle and the cell is nearer than rmin3[b] - res, where
  rmin3[b] is the min valid range of b and its two neighbours (ends
  replicated);
- it gains l_occ once for every hitting beam whose floor-exact endpoint
  cell it is (the counts stack);
- out = clip(g + (l_free * free + l_occ * count) * enable, +-l_clamp).

`update_hybrid` sends a CUDA tensor to the kernel and a CPU tensor to
`update_hybrid_plain`; anything else raises.
"""

from __future__ import annotations

import math

import torch

from slam2d_tpu_torch.core.numerics import inv_f32
from slam2d_tpu_torch.ops import _build

_MAX_BEAMS = 2048  # 3 f32 tables of this length fit the kernel's 48 KB smem


def update_hybrid_plain(
    grid, pose, ranges, angles, *, origin_xy, resolution, step, angle_min,
    min_range, max_range, l_free, l_occ, l_clamp, enable=1.0,
):
    """Plain PyTorch version of the kernel, same float32 operations.

    The free test needs only the two beams whose slots can hold the
    cell's bearing, floor(phi / step) and the next one: any other beam is
    at least a whole step away, so checking those two is exactly the
    reference's test against every beam."""
    H, W = grid.shape
    B = ranges.shape[0]
    dev = grid.device
    ox, oy = origin_xy
    r = torch.clamp(ranges, 0.0, max_range)
    valid = (ranges > min_range) & torch.isfinite(ranges)
    hit = valid & (ranges < max_range)
    rv = torch.where(valid, r, math.inf)
    rmin3 = torch.minimum(
        rv,
        torch.minimum(
            torch.cat([rv[:1], rv[:-1]]), torch.cat([rv[1:], rv[-1:]])
        ),
    )
    rmin3 = torch.where(valid & torch.isfinite(rmin3), rmin3, -1.0)

    col = torch.arange(W, dtype=torch.float32, device=dev)
    row = torch.arange(H, dtype=torch.float32, device=dev)
    cx = (ox + (col + 0.5) * resolution - pose[0])[None, :]
    cy = (oy + (row + 0.5) * resolution - pose[1])[:, None]
    d = torch.sqrt(cx * cx + cy * cy)
    phi = torch.atan2(cy.expand(H, W), cx.expand(H, W)) - pose[2] - angle_min
    phi = torch.remainder(phi + math.pi, 2 * math.pi) - math.pi
    k0 = torch.floor(phi / step)
    free = torch.zeros((H, W), dtype=torch.bool, device=dev)
    for k in (k0, k0 + 1):
        kb = torch.clamp(k, 0, B - 1).to(torch.int64)
        ab = kb.to(torch.float32) * step
        free |= (
            (k >= 0) & (k <= B - 1)
            & (torch.abs(phi - ab) <= 0.5 * step)
            & (d < rmin3[kb] - resolution)
        )

    a = angles + pose[2]
    inv_res = inv_f32(resolution)
    ecol = torch.floor((pose[0] + torch.cos(a) * r - ox) * inv_res)
    erow = torch.floor((pose[1] + torch.sin(a) * r - oy) * inv_res)
    on = hit & (erow >= 0) & (erow < H) & (ecol >= 0) & (ecol < W)
    idx = torch.where(on, erow * W + ecol, 0.0).to(torch.int64)
    count = torch.zeros(H * W, dtype=torch.float32, device=dev)
    count.index_put_((idx,), on.to(torch.float32), accumulate=True)

    upd = (l_free * free.to(torch.float32) + l_occ * count.view(H, W)) * enable
    return torch.clamp(grid + upd, -l_clamp, l_clamp)


def _check(grid, pose, ranges, angles):
    dev = grid.device
    if grid.dim() != 2 or grid.dtype != torch.float32:
        raise ValueError(
            f"grid must be a 2-D float32 tensor, got {grid.dtype} "
            f"{tuple(grid.shape)}"
        )
    B = ranges.shape[0] if ranges.dim() == 1 else -1
    for name, t, shape in (
        ("pose", pose, (3,)), ("ranges", ranges, (B,)), ("angles", angles, (B,))
    ):
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(
                f"{name} must be float32 of shape {shape}, got {t.dtype} "
                f"{tuple(t.shape)}"
            )
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, grid on {dev}")
    for name, t in (
        ("grid", grid), ("pose", pose), ("ranges", ranges), ("angles", angles)
    ):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not 1 <= B <= _MAX_BEAMS:
        raise ValueError(f"need 1..{_MAX_BEAMS} beams, got {B}")


def update_hybrid(
    grid, pose, ranges, angles, *, origin_xy, resolution, step, angle_min,
    min_range, max_range, l_free, l_occ, l_clamp, enable=1.0, plain=False,
):
    """Updated copy of `grid` [H, W] f32 after one scan from `pose` [3].

    `ranges` [B] and `angles` [B] (the float32 beam-angle table) lie on
    the grid's device; `origin_xy` is the float world origin of cell
    (0, 0). The other arguments are the sensor and grid constants.
    `plain=True` runs the plain version on a CUDA tensor too: it is meant
    for checks of the kernel against it, not for use."""
    _check(grid, pose, ranges, angles)
    kw = dict(
        origin_xy=origin_xy, resolution=resolution, step=step,
        angle_min=angle_min, min_range=min_range, max_range=max_range,
        l_free=l_free, l_occ=l_occ, l_clamp=l_clamp, enable=enable,
    )
    if plain or grid.device.type == "cpu":
        return update_hybrid_plain(grid, pose, ranges, angles, **kw)
    if grid.device.type != "cuda":
        raise ValueError(f"no update kernel for device {grid.device}")
    H, W = grid.shape
    out = torch.empty_like(grid)
    lib = _build.load_library()
    err = lib.slam2d_update_hybrid(
        grid.data_ptr(), out.data_ptr(), pose.data_ptr(), ranges.data_ptr(),
        angles.data_ptr(), H, W, ranges.shape[0],
        origin_xy[0], origin_xy[1], resolution, step, angle_min, min_range,
        max_range, l_free, l_occ, l_clamp, enable,
        _build.stream_handle(grid.device),
    )
    _build.check(err, "slam2d_update_hybrid")
    update_hybrid.launches += 1
    return out


update_hybrid.launches = 0
