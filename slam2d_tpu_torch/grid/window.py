"""Static-size window extraction around a pose.

Port of slam2d_tpu/grid/window.py. Window sizes are derived from the
config exactly as in the JAX package. Window origins are host integers:
the frontend reads the window center in the same host read as its
motion gate, so a window costs no extra device sync.

`write_window` and `write_window_blur_exact` write into `arr` IN PLACE
and return it (the JAX package returns a new array); the frontend owns
its map tensors, and this saves a full-map copy per update.
"""

from __future__ import annotations

import math

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
