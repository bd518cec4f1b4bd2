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
`search_space_plain`; anything else raises.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from slam2d_tpu_torch.core.numerics import inv_f32
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


def search_space(
    logodds, taps: np.ndarray, *, occ_sat: float, free_threshold: float,
    free_penalty: float, plain: bool = False,
):
    """Search space [H, W] float32 of a log-odds map [H, W] float32.

    `taps` is the odd-length float32 blur kernel (host numpy).
    `plain=True` runs the plain version on a CUDA tensor too, for checks
    of the kernel only."""
    taps = np.ascontiguousarray(taps, np.float32)
    if logodds.dim() != 2 or logodds.dtype != torch.float32:
        raise ValueError(
            f"logodds must be a 2-D float32 tensor, got {logodds.dtype} "
            f"{tuple(logodds.shape)}"
        )
    if not logodds.is_contiguous():
        raise ValueError("logodds must be contiguous")
    if taps.ndim != 1 or len(taps) % 2 == 0 or len(taps) > _MAX_TAPS:
        raise ValueError(f"need an odd number of taps up to {_MAX_TAPS}")
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
