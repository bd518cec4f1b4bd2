"""Float32 arithmetic the plain references share: SE(2) algebra, XLA's
rounding rules, the blur and the map-window helpers.

Frozen copies, at commit fe37ab964ea616f84f82d44417eea1bff9015b6b, of
slam2d_tpu_torch/core/se2.py (wrap_angle, compose, inverse, between,
rotate_points), core/numerics.py (inv_f32, fma_f32, atan2_ref),
ops/search_space.py (separable_blur, search_space_plain),
match/correlative.py (gaussian_kernel_1d) and grid/window.py (the window
sizes and the device-origin window helpers). They are plain PyTorch and
import nothing of the program: the same float32 operations in the same
order give the same bits on the same device, so a reference that follows
the program's semantics can be held to it cell for cell.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

_PI = math.pi
_TWO_PI = 2.0 * math.pi


def wrap_angle(theta):
    """Wrap to (-pi, pi]."""
    return torch.remainder(theta + _PI, _TWO_PI) - _PI


def compose(a, b):
    """a ⊕ b: apply pose b expressed in a's frame. Shapes broadcast."""
    ax, ay, ath = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bth = b[..., 0], b[..., 1], b[..., 2]
    c, s = torch.cos(ath), torch.sin(ath)
    return torch.stack(
        [ax + c * bx - s * by, ay + s * bx + c * by, wrap_angle(ath + bth)],
        dim=-1,
    )


def inverse(a):
    ax, ay, ath = a[..., 0], a[..., 1], a[..., 2]
    c, s = torch.cos(ath), torch.sin(ath)
    return torch.stack(
        [-(c * ax + s * ay), -(-s * ax + c * ay), wrap_angle(-ath)], dim=-1
    )


def between(a, b):
    """a⁻¹ ⊕ b: pose of b expressed in a's frame (odometry delta)."""
    return compose(inverse(a), b)


def rotate_points(theta, pts):
    """Rotate points ([..., N, 2]) by theta ([...])."""
    c = torch.cos(theta)[..., None]
    s = torch.sin(theta)[..., None]
    px, py = pts[..., 0], pts[..., 1]
    return torch.stack([c * px - s * py, s * px + c * py], dim=-1)


def inv_f32(c: float) -> float:
    """fl32(1 / fl32(c)): XLA compiles `x / c` as `x * fl32(1 / c)`."""
    return float(np.float32(1.0) / np.float32(c))


_F32_LOW = (1 << 29) - 1
_F32_TIE = 1 << 28


def _f64(x):
    if isinstance(x, torch.Tensor):
        return x.double()
    return float(np.float32(x))


def fma_f32(a, b, c):
    """fl32(a * b + c) with one rounding: the float64 sum rounded once,
    and on a float32 midpoint its last bit moved to the side of the sum's
    exact error (TwoSum) first."""
    p, c = _f64(a) * _f64(b), _f64(c)
    s = p + c
    out = s.float()
    tie = (s.view(torch.int64) & _F32_LOW) == _F32_TIE
    if bool(tie.any()):
        p, c, s = (torch.broadcast_to(torch.as_tensor(x, device=s.device),
                                      s.shape)[tie] for x in (p, c, s))
        t = s - p
        err = (p - (s - t)) + (c - t)
        out[tie] = torch.where(err != 0, torch.nextafter(s, err * math.inf),
                               s).float()
    return out


_ATAN_01 = (0.9999993329, -0.3332985605, 0.1994653599, -0.1390853351,
            0.0964200441, -0.0559098861, 0.0218612288, -0.0040540580)


def atan2_ref(y, x):
    """The reference update kernel's polynomial arctangent, each Horner
    step one FMA, folded into (-pi, pi]."""
    ax, ay = torch.abs(x), torch.abs(y)
    q = torch.minimum(ax, ay) / torch.clamp(torch.maximum(ax, ay), min=1e-20)
    q2 = q * q
    p = torch.full_like(q, _ATAN_01[-1])
    for c in _ATAN_01[-2::-1]:
        p = fma_f32(q2, p, c)
    a = q * p
    a = torch.where(ay > ax, float(np.float32(0.5 * np.pi)) - a, a)
    a = torch.where(x < 0, float(np.float32(np.pi)) - a, a)
    return torch.where(y < 0, -a, a)


def gaussian_kernel_1d(sigma: float, halfwidth: int) -> np.ndarray:
    x = np.arange(-halfwidth, halfwidth + 1, dtype=np.float32)
    k = np.exp(-0.5 * (x / max(sigma, 1e-6)) ** 2)
    return (k / k.max()).astype(np.float32)


def separable_blur(img, taps: np.ndarray):
    """Zero-padded separable blur of the last two axes (rows, then
    columns), each accumulating from tap 0 upward."""
    hw = len(taps) // 2

    def blur_axis(x, axis):
        size = x.shape[axis]
        pad = (0, 0, hw, hw) if axis == -2 else (hw, hw, 0, 0)
        xp = F.pad(x, pad)
        acc = None
        for i, kv in enumerate(taps):
            term = float(kv) * xp.narrow(axis, i, size)
            acc = term if acc is None else acc + term
        return acc

    return blur_axis(blur_axis(img, -2), -1)


def search_space_plain(logodds, taps, occ_sat, free_threshold, free_penalty):
    """The likelihood field of a log-odds map: clipped evidence, blurred,
    minus a penalty in known-free space."""
    occ = torch.clamp(logodds * inv_f32(occ_sat), 0.0, 1.0)
    blur = torch.clamp(separable_blur(occ, taps), 0.0, 1.0)
    free = (torch.sigmoid(logodds) < free_threshold).to(torch.float32)
    return blur - free_penalty * free * (1.0 - blur)


def blur_halo_cells(mcfg: dict, resolution: float) -> int:
    return max(4, int(math.ceil(3.0 * mcfg["sigma_m"] / resolution)))


def scan_window_cells(grid: dict, sensor: dict, mcfg: dict) -> int:
    """Window covering what one scan can read: endpoints, the translation
    search, the blur halo and slack, rounded up to 8 * coarse_factor."""
    res = grid["resolution"]
    half = (int(math.ceil(sensor["max_range"] / res))
            + int(round(mcfg["search_xy"] / res))
            + blur_halo_cells(mcfg, res) + 8)
    mult = 8 * mcfg["coarse_factor"]
    size = ((2 * half + mult - 1) // mult) * mult
    return min(size, min(grid["height"], grid["width"]))


def update_window_cells(grid: dict, sensor: dict, mcfg: dict | None = None
                        ) -> int:
    """Window covering what one scan's map update can touch (with `mcfg`,
    also twice the blur halo)."""
    res = grid["resolution"]
    half = int(math.ceil(sensor["max_range"] / res)) + 8
    if mcfg is not None:
        half += 2 * blur_halo_cells(mcfg, res)
    size = ((2 * half + 7) // 8) * 8
    return min(size, min(grid["height"], grid["width"]))


def origin_xy(grid: dict):
    """World (x, y) of the map's cell (0, 0) corner."""
    res = grid["resolution"]
    return (grid["center_x"] - (grid["width"] // 2) * res,
            grid["center_y"] - (grid["height"] // 2) * res)


def world_to_cell(xy, grid: dict):
    """World (x, y) -> integer (row, col), not clipped."""
    ox, oy = origin_xy(grid)
    inv = inv_f32(grid["resolution"])
    col = (xy[..., 0] - ox) * inv
    row = (xy[..., 1] - oy) * inv
    return torch.floor(torch.stack([row, col], dim=-1)).to(torch.int32)


def cell_center_world(rc, grid: dict):
    ox, oy = origin_xy(grid)
    row = rc[..., 0].to(torch.float32)
    col = rc[..., 1].to(torch.float32)
    res = grid["resolution"]
    return torch.stack([(col + 0.5) * res + ox, (row + 0.5) * res + oy],
                       dim=-1)


def window_origin_t(center_rc, size: int, H: int, W: int):
    """Top-left (r0, c0) int32 of a size x size window centred near
    `center_rc`, clamped into the map."""
    c = center_rc.to(torch.int64)
    return torch.stack([
        torch.clamp(c[0] - size // 2, 0, H - size),
        torch.clamp(c[1] - size // 2, 0, W - size),
    ]).to(torch.int32)


def window_origin_xy_t(ox: float, oy: float, resolution: float, origin):
    """Float32 world origin (x, y) of the window at cell `origin`."""
    f = origin.to(torch.float32) * resolution
    return torch.stack([f[..., 1] + ox, f[..., 0] + oy], dim=-1)


def take_window(arr, origin, size: int):
    r0, c0 = (int(v) for v in origin.tolist())
    return arr[r0:r0 + size, c0:c0 + size].clone()


def put_window(arr, window, origin):
    r0, c0 = (int(v) for v in origin.tolist())
    h, w = window.shape
    arr[r0:r0 + h, c0:c0 + w] = window
    return arr


def blur_exact_keep(origin, size: int, shape, margin: int):
    """[size, size] bool: the freshly blurred window's cells written back
    (the halo ring trimmed except against the map's border)."""
    H, W = shape
    r0, c0 = (int(v) for v in origin.tolist())
    top = 0 if r0 == 0 else margin
    bottom = size if r0 == H - size else size - margin
    left = 0 if c0 == 0 else margin
    right = size if c0 == W - size else size - margin
    r = torch.arange(size, device=origin.device)[:, None]
    c = torch.arange(size, device=origin.device)[None, :]
    return (r >= top) & (r < bottom) & (c >= left) & (c < right)


def beam_angles(sensor: dict, device) -> torch.Tensor:
    """[B] float32: the float64 table cast once."""
    n = sensor["n_beams"]
    step = sensor["fov_rad"] / max(n - 1, 1)
    return torch.as_tensor(
        (sensor["angle_min"] + step * np.arange(n)).astype(np.float32),
        device=device)


def scan_endpoints_local(ranges, sensor: dict):
    """Endpoints [B, 2] in the sensor frame and the hits' mask [B]."""
    angles = beam_angles(sensor, ranges.device)
    r = ranges.to(torch.float32)
    valid = ((r > sensor["min_range"]) & (r < sensor["max_range"])
             & torch.isfinite(r))
    r_clip = torch.clamp(r, 0.0, sensor["max_range"])
    pts = torch.stack(
        [r_clip * torch.cos(angles), r_clip * torch.sin(angles)], dim=-1)
    return pts, valid


def beam_step(sensor: dict) -> float:
    return sensor["fov_rad"] / max(sensor["n_beams"] - 1, 1)


def argmax3(scores):
    """(t, r, c) of the first maximum of a [T, R, C] tensor, as ints."""
    T, R, C = scores.shape
    i = int(torch.argmax(scores.reshape(-1)))
    return i // (R * C), (i % (R * C)) // C, i % C
