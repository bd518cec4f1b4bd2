"""Search-space build: the blurred likelihood field of a log-odds map.

Kernel: csrc/search_space.cu, the port of slam2d_tpu/ops/pallas_blur.py:
_blur_kernel fused with the rest of the JAX package's
match/correlative.py:build_search_space:

    occ  = clip(l / occ_sat, 0, 1)      (as l * fl32(1 / occ_sat), like XLA)
    blur = clip(separable zero-padded blur of occ, rows then columns, 0, 1)
    S    = blur - free_penalty * [sigmoid(l) < free_threshold] * (1 - blur)

The kernel is one launch a call: a block a tile of S, the tile and its
blur halo copied into shared memory once and blurred there.
`search_space` sends a CUDA tensor to the kernel and a CPU tensor to
`search_space_plain`; anything else raises. `search_space_window` is the
frontend step's form: S of a window of the map whose origin and gate lie
in device memory, written in place into the cells that
grid/window.py:write_window_blur_exact keeps.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from slam2d_tpu_torch.core.numerics import inv_f32
from slam2d_tpu_torch.grid.window import (
    blur_exact_keep,
    check_window_operands,
    put_window,
    take_window,
)
from slam2d_tpu_torch.ops import _build

_MAX_TAPS = 63  # csrc/search_space.cu passes the taps by value


def separable_blur(img, taps: np.ndarray):
    """Zero-padded separable blur of the last two axes of `img` (rows,
    then columns), each accumulating from tap 0 upward (the JAX package's
    _separable_blur, batched over any leading axes)."""
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
    """Plain PyTorch version of the kernel, same float32 operations."""
    occ = torch.clamp(logodds * inv_f32(occ_sat), 0.0, 1.0)
    blur = torch.clamp(separable_blur(occ, taps), 0.0, 1.0)
    free = (torch.sigmoid(logodds) < free_threshold).to(torch.float32)
    return blur - free_penalty * free * (1.0 - blur)


def _check_taps(logodds, taps):
    if logodds.dim() != 2 or logodds.dtype != torch.float32:
        raise ValueError(
            f"logodds must be a 2-D float32 tensor, got {logodds.dtype} "
            f"{tuple(logodds.shape)}"
        )
    if not logodds.is_contiguous():
        raise ValueError("logodds must be contiguous")
    if taps.ndim != 1 or len(taps) % 2 == 0 or len(taps) > _MAX_TAPS:
        raise ValueError(f"need an odd number of taps up to {_MAX_TAPS}")


def search_space(
    logodds, taps: np.ndarray, *, occ_sat: float, free_threshold: float,
    free_penalty: float, plain: bool = False,
):
    """Search space [H, W] float32 of a log-odds map [H, W] float32.

    `taps` is the odd-length float32 blur kernel (host numpy).
    `plain=True` runs the plain version on a CUDA tensor too, for checks
    of the kernel only."""
    taps = np.ascontiguousarray(taps, np.float32)
    _check_taps(logodds, taps)
    if plain or logodds.device.type == "cpu":
        return search_space_plain(
            logodds, taps, occ_sat, free_threshold, free_penalty
        )
    if logodds.device.type != "cuda":
        raise ValueError(f"no search-space kernel for device {logodds.device}")
    H, W = logodds.shape
    out = torch.empty_like(logodds)
    lib = _build.load_library()
    err = lib.slam2d_search_space(
        logodds.data_ptr(), out.data_ptr(), H, W,
        taps.ctypes.data, len(taps), inv_f32(occ_sat), free_threshold,
        free_penalty,
        _build.stream_handle(logodds.device),
    )
    _build.check(err, "slam2d_search_space")
    search_space.launches += 1
    return out


search_space.launches = 0


def search_space_window_plain(logodds, S, taps, *, origin, size, margin,
                              gate, occ_sat, free_threshold, free_penalty):
    """Plain version of the window form, in place: the log-odds window
    gathered at the device origin, `search_space_plain` of it, and the
    window of S written back with the new values on the kept cells where
    the gate is true and the old values elsewhere."""
    if origin is None:
        g, old = logodds[: size[0], : size[1]], S[: size[0], : size[1]]
        origin_t = torch.zeros(2, dtype=torch.int32, device=S.device)
    else:
        g, old = take_window(logodds, origin, size), take_window(S, origin, size)
        origin_t = origin
    new = search_space_plain(g, taps, occ_sat, free_threshold, free_penalty)
    keep = blur_exact_keep(origin_t, size, tuple(S.shape), margin)
    if gate is not None:
        keep = keep & gate.reshape(())
    new = torch.where(keep, new, old)
    if origin is None:
        S[: size[0], : size[1]] = new
        return S
    return put_window(S, new, origin)


def search_space_window(
    logodds, S, taps: np.ndarray, *, origin, size, margin: int, gate,
    occ_sat: float, free_threshold: float, free_penalty: float,
    plain: bool = False,
):
    """Kernel 3 in place: the search space of the (h, w) = `size` window
    of `logodds` [H, W] at the int32 device origin `origin` (r0, c0)
    (None: cell (0, 0)), written into `S` [H, W] on the cells that
    grid/window.py:write_window_blur_exact keeps (the `margin` ring
    trimmed except on sides clamped against the map border), when the
    bool device tensor `gate` is true (None: always). The kept cells get
    the bits of extract_window -> search_space -> write_window_blur_exact;
    a gate of 0 leaves S bit-identical. A window smaller than the map
    needs margin >= len(taps) // 2 (the kept cells' blur then reads only
    the window). One launch; nothing is read back to the host. Returns S."""
    taps = np.ascontiguousarray(taps, np.float32)
    _check_taps(logodds, taps)
    check_window_operands(logodds, origin, gate, size)
    h, w = size
    H, W = logodds.shape
    if (S.shape != logodds.shape or S.dtype != torch.float32
            or S.device != logodds.device or not S.is_contiguous()):
        raise ValueError("S must be a contiguous float32 tensor of the map's "
                         "shape and device")
    if (h < H or w < W) and margin < len(taps) // 2:
        raise ValueError(f"margin {margin} < {len(taps) // 2}: a kept cell's "
                         "blur would read outside its window")
    if not 0 <= 2 * margin <= min(h, w):
        raise ValueError(f"margin {margin} for a window of {size}")
    kw = dict(origin=origin, size=(h, w), margin=margin, gate=gate,
              occ_sat=occ_sat, free_threshold=free_threshold,
              free_penalty=free_penalty)
    if plain or logodds.device.type == "cpu":
        return search_space_window_plain(logodds, S, taps, **kw)
    if logodds.device.type != "cuda":
        raise ValueError(f"no search-space kernel for device {logodds.device}")
    lib = _build.load_library()
    err = lib.slam2d_search_space_window(
        logodds.data_ptr(), S.data_ptr(), H, W,
        None if origin is None else origin.data_ptr(),
        None if gate is None else gate.data_ptr(), h, w, margin,
        taps.ctypes.data, len(taps), inv_f32(occ_sat), free_threshold,
        free_penalty, _build.stream_handle(logodds.device),
    )
    _build.check(err, "slam2d_search_space_window")
    search_space.launches += 1
    return S
