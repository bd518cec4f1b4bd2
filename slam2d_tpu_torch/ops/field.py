"""Per-particle window of the map and its likelihood field.

Kernel: csrc/window_field.cu, the port of
slam2d_tpu/ops/pallas_field.py:_field_kernel (fused_window_field): for
every particle p and its UNCLAMPED window origin origins[p] = (a, b),

    g    = maps[p, a:a+win, b:b+win], cells off the map read as 0
    occ  = clip(g * inv_sat, 0, 1)
    blur = clip(separable zero-padded blur of occ, rows then columns, 0, 1)
    S    = blur - free_penalty * [g < free_logit] * (1 - blur)

returned as [P, win, win] in `out_dtype` (float32 or bfloat16). The free
test compares the log-odds with logit(free_threshold), as the TPU kernel
does (build_search_space compares the sigmoid with the threshold; the two
differ only on a value within an ulp of the threshold).

The kernel has five variants, chosen from the operands alone
(csrc/window_field.cu). With 9 symmetric non-negative taps, the configs'
blur: the tiles of the maps arrive by TMA ("tma") when the maps' base and
row pitch are 16-byte aligned, else the threads load them ("coop"); the
field leaves in 16-byte stores ("packed") when its rows are 16-byte
aligned, else cell by cell ("scalar"). Any other taps take "generic".

`window_field` sends a CUDA tensor to the kernel and a CPU tensor to
`window_field_plain`; anything else raises.
"""

from __future__ import annotations

import numpy as np
import torch

from slam2d_tpu_torch.ops import _build
from slam2d_tpu_torch.ops.search_space import separable_blur

_MAX_TAPS = 63  # csrc/window_field.cu passes the taps by value
_DTYPES = (torch.float32, torch.bfloat16)
VARIANTS = ("tma+packed", "tma+scalar", "coop+packed", "coop+scalar",
            "generic")  # the C layer's codes


def unclamped_windows(maps, origins, win: int):
    """[P, win, win] windows of maps [P, H, W] at UNCLAMPED top-left cells
    origins [P, 2] (row, col); cells off the map read as 0 (log-odds 0:
    unknown). The windows keep the maps' dtype."""
    P, H, W = maps.shape
    dev = maps.device
    ar = torch.arange(win, device=dev)
    rows = origins[:, 0:1].to(torch.int64) + ar                # [P, win]
    cols = origins[:, 1:2].to(torch.int64) + ar
    inside = (
        ((rows >= 0) & (rows < H))[:, :, None]
        & ((cols >= 0) & (cols < W))[:, None, :]
    )
    g = maps[
        torch.arange(P, device=dev)[:, None, None],
        torch.clamp(rows, 0, H - 1)[:, :, None],
        torch.clamp(cols, 0, W - 1)[:, None, :],
    ]
    return torch.where(inside, g, torch.zeros((), dtype=maps.dtype, device=dev))


def window_field_plain(
    maps, origins, win, taps, inv_sat, free_logit, free_penalty, out_dtype
):
    """Plain PyTorch version of the kernel, same float32 operations."""
    g = unclamped_windows(maps, origins, win).to(torch.float32)
    occ = torch.clamp(g * inv_sat, 0.0, 1.0)
    blur = torch.clamp(separable_blur(occ, taps), 0.0, 1.0)
    free = (g < free_logit).to(torch.float32)
    return (blur - free_penalty * free * (1.0 - blur)).to(out_dtype)


def window_field(
    maps, origins, win: int, taps: np.ndarray, *, inv_sat: float,
    free_logit: float, free_penalty: float, out_dtype=torch.float32,
    plain: bool = False,
):
    """Fields [P, win, win] of every particle's map window (see the module
    docstring). `maps` [P, H, W] float32 or bfloat16, `origins` [P, 2]
    int32 (row, col) on the same device, `taps` the odd-length float32
    blur kernel (host numpy). `plain=True` runs the plain version on a
    CUDA tensor too, for checks of the kernel only."""
    taps = np.ascontiguousarray(taps, np.float32)
    if maps.dim() != 3 or maps.dtype not in _DTYPES:
        raise ValueError(
            "maps must be a [P, H, W] float32 or bfloat16 tensor, got "
            f"{maps.dtype} {tuple(maps.shape)}"
        )
    P, H, W = maps.shape
    if origins.dtype != torch.int32 or tuple(origins.shape) != (P, 2):
        raise ValueError(
            f"origins must be int32 of shape ({P}, 2), got {origins.dtype} "
            f"{tuple(origins.shape)}"
        )
    if origins.device != maps.device:
        raise ValueError(f"origins are on {origins.device}, maps on {maps.device}")
    if not (maps.is_contiguous() and origins.is_contiguous()):
        raise ValueError("maps and origins must be contiguous")
    if taps.ndim != 1 or len(taps) % 2 == 0 or len(taps) > _MAX_TAPS:
        raise ValueError(f"need an odd number of taps up to {_MAX_TAPS}")
    if out_dtype not in _DTYPES or win < 1 or not 1 <= P <= 65535:
        raise ValueError(f"bad out_dtype {out_dtype}, win {win} or P {P}")
    if plain or maps.device.type == "cpu":
        return window_field_plain(
            maps, origins, win, taps, inv_sat, free_logit, free_penalty,
            out_dtype,
        )
    if maps.device.type != "cuda":
        raise ValueError(f"no field kernel for device {maps.device}")
    out = torch.empty((P, win, win), dtype=out_dtype, device=maps.device)
    lib = _build.load_library()
    err = lib.slam2d_window_field(
        maps.data_ptr(), int(maps.dtype == torch.bfloat16), origins.data_ptr(),
        out.data_ptr(), int(out_dtype == torch.bfloat16), P, H, W, win,
        taps.ctypes.data, len(taps), inv_sat, free_logit, free_penalty,
        _build.stream_handle(maps.device),
    )
    _build.check(err, "slam2d_window_field")
    window_field.launches += 1
    return out


def last_variant() -> str:
    """The kernel variant that the last launch of `window_field` ran."""
    return VARIANTS[_build.load_library().slam2d_window_field_last_variant()]


window_field.launches = 0
