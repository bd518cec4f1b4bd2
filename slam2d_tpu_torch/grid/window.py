"""Static-size window extraction around a pose.

Port of slam2d_tpu/grid/window.py. Window sizes are derived from the
config exactly as in the JAX package. Two forms of a window origin:

- host integers (`window_origin`, `extract_window`, `write_window`,
  `write_window_blur_exact`), for the callers that know their window on
  the host: full SLAM's submaps and rebuilds, the tiles, the checks;
- an int32 device tensor (r0, c0) (`window_origin_t`, `take_window`,
  `put_window`, `blur_exact_keep`, `window_origin_xy_t`), for the
  frontend step, which clamps its windows on the device as the JAX
  package does and reads nothing back to the host.

`write_window`, `write_window_blur_exact` and `put_window` write into
`arr` IN PLACE and return it (the JAX package returns a new array); the
frontend owns its map tensors, and this saves a full-map copy per update.
"""

from __future__ import annotations

import functools
import math

import torch

from slam2d_tpu_torch.config import GridConfig, MatcherConfig, SensorConfig


def blur_halo_cells(mcfg: MatcherConfig, resolution: float) -> int:
    sigma_cells = mcfg.sigma_m / resolution
    return max(4, int(math.ceil(3.0 * sigma_cells)))


def scan_window_cells(
    gcfg: GridConfig, sensor: SensorConfig, mcfg: MatcherConfig
) -> int:
    """Static window size covering everything one scan can touch or read:
    endpoints (max_range) + translation search + blur halo + slack.
    Rounded up to a multiple of 8 * coarse_factor; capped at the grid size."""
    half = (
        int(math.ceil(sensor.max_range / gcfg.resolution))
        + int(round(mcfg.search_xy / gcfg.resolution))
        + blur_halo_cells(mcfg, gcfg.resolution)
        + 8
    )
    size = 2 * half
    mult = 8 * mcfg.coarse_factor
    size = ((size + mult - 1) // mult) * mult
    return min(size, min(gcfg.height, gcfg.width))


def update_window_cells(
    gcfg: GridConfig, sensor: SensorConfig, mcfg: MatcherConfig | None = None
) -> int:
    """Static window size covering everything one scan's map update can
    touch: endpoints (max_range) + slack. With `mcfg` the window also
    covers the blur halo around every touched cell plus the halo ring
    `write_window_blur_exact` trims on writeback (2x halo total)."""
    half = int(math.ceil(sensor.max_range / gcfg.resolution)) + 8
    if mcfg is not None:
        half += 2 * blur_halo_cells(mcfg, gcfg.resolution)
    size = 2 * half
    size = ((size + 7) // 8) * 8
    return min(size, min(gcfg.height, gcfg.width))


def window_origin(center_rc, size: int, H: int, W: int) -> tuple[int, int]:
    """Top-left (row, col) of a size x size window centered near the
    integer center_rc, clamped so the window lies fully inside the grid."""
    r0 = min(max(int(center_rc[0]) - size // 2, 0), H - size)
    c0 = min(max(int(center_rc[1]) - size // 2, 0), W - size)
    return r0, c0


def extract_window(arr, center_rc, size: int):
    """Returns (contiguous copy of the window [size, size], (r0, c0))."""
    H, W = arr.shape
    r0, c0 = window_origin(center_rc, size, H, W)
    return arr[r0 : r0 + size, c0 : c0 + size].contiguous(), (r0, c0)


def write_window(arr, window, origin_rc):
    """Write `window` into `arr` at `origin_rc`, in place."""
    r0, c0 = origin_rc
    h, w = window.shape
    arr[r0 : r0 + h, c0 : c0 + w] = window
    return arr


def write_window_blur_exact(arr, window, origin_rc, margin: int):
    """Write back a freshly-blurred window, in place: trim the blur-halo
    ring EXCEPT on sides where the window is clamped against the array
    border — there the window edge IS the array edge, so the blur's zero
    padding matches reality and the ring is exact. The kept cells form a
    rectangle, so this is one copy."""
    H, W = arr.shape
    size = window.shape[0]
    r0, c0 = origin_rc
    top = 0 if r0 == 0 else margin
    bottom = size if r0 == H - size else size - margin
    left = 0 if c0 == 0 else margin
    right = size if c0 == W - size else size - margin
    arr[r0 + top : r0 + bottom, c0 + left : c0 + right] = window[
        top:bottom, left:right
    ]
    return arr


def window_origin_t(center_rc, size, H: int, W: int):
    """`window_origin` on the device: the top-left (r0, c0) of a window of
    `size` (an int, or (h, w)) centered near the integer tensor
    `center_rc` [2], clamped into the grid, as an int32 tensor [2]."""
    h, w = (size, size) if isinstance(size, int) else size
    c = center_rc.to(torch.int64)
    return torch.stack([
        torch.clamp(c[0] - h // 2, 0, H - h),
        torch.clamp(c[1] - w // 2, 0, W - w),
    ]).to(torch.int32)


@functools.cache
def _window_offsets(W: int, h: int, w: int, device) -> torch.Tensor:
    """[h, w] int64 flat offsets of a window's cells from its top-left
    cell in a row-major array of W columns. Cached, so a window costs no
    host-to-device copy; callers must not write into it."""
    r = torch.arange(h, dtype=torch.int64, device=device)
    c = torch.arange(w, dtype=torch.int64, device=device)
    return r[:, None] * W + c[None, :]


def window_index(arr, origin, size):
    """[h, w] int64 flat indices into `arr` [H, W] of the window of `size`
    ((h, w)) at the device origin `origin` [2]."""
    h, w = size
    W = arr.shape[1]
    o = origin.to(torch.int64)
    return _window_offsets(W, h, w, arr.device) + (o[0] * W + o[1])


def take_window(arr, origin, size):
    """A copy [h, w] of the window of `size` ((h, w)) of `arr` at the
    device origin `origin` (one gather)."""
    return torch.take(arr, window_index(arr, origin, size))


def put_window(arr, window, origin):
    """Write `window` [h, w] into `arr` at the device origin, in place."""
    idx = window_index(arr, origin, tuple(window.shape))
    arr.view(-1).index_copy_(0, idx.reshape(-1), window.reshape(-1))
    return arr


def blur_exact_keep(origin, size, shape, margin: int):
    """[h, w] bool: the cells of a freshly blurred window at the device
    origin that `write_window_blur_exact` keeps (the halo ring trimmed
    except on sides clamped against the array border)."""
    h, w = size
    H, W = shape
    o = origin.to(torch.int64)
    dev = origin.device
    top = torch.where(o[0] == 0, 0, margin)
    bottom = torch.where(o[0] == H - h, h, h - margin)
    left = torch.where(o[1] == 0, 0, margin)
    right = torch.where(o[1] == W - w, w, w - margin)
    r = torch.arange(h, device=dev)[:, None]
    c = torch.arange(w, device=dev)[None, :]
    return (r >= top) & (r < bottom) & (c >= left) & (c < right)


def window_origin_xy_t(ox: float, oy: float, resolution: float, origin):
    """Float32 world origin [..., 2] (x, y) of the window whose top-left
    cell is the device tensor `origin` [..., 2] (r0, c0) on a lattice of
    origin (ox, oy) and cell size `resolution`: ox + f32(c0) * res as two
    float32 operations, the rounding of grid/occupancy.py:
    window_origin_xy."""
    f = origin.to(torch.float32) * resolution
    return torch.stack([f[..., 1] + ox, f[..., 0] + oy], dim=-1)


def check_window_operands(grid, origin, gate, size):
    """Raise unless (h, w) = `size` fits the map `grid` [H, W], `origin`
    is a contiguous int32 (r0, c0) tensor and `gate` a one-element bool
    tensor, both on the map's device (either may be None): the window
    operands of the in-place kernels."""
    H, W = grid.shape
    h, w = size
    if not (1 <= h <= H and 1 <= w <= W):
        raise ValueError(f"window {size} does not fit the map {(H, W)}")
    if origin is not None and (
        origin.dtype != torch.int32 or tuple(origin.shape) != (2,)
        or origin.device != grid.device or not origin.is_contiguous()
    ):
        raise ValueError("origin must be a contiguous int32 (r0, c0) tensor "
                         "on the map's device")
    if gate is not None and (
        gate.dtype != torch.bool or gate.numel() != 1
        or gate.device != grid.device
    ):
        raise ValueError("gate must be a one-element bool tensor on the "
                         "map's device")
