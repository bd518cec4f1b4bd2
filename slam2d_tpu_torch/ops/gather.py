"""Ancestor-row gather of the particle filter's resampling step.

Kernel: csrc/gather_rows.cu, the port of
slam2d_tpu/ops/pallas_gather.py:_copy_kernel (gather_rows_pallas):
out[p] = x[ancestors[p]] over the leading axis of a [P, ...] tensor, out
of place (a row can be both a source and a destination), bit-exact for
every dtype.

The kernel copies in the widest words that the row length and both
pointers are aligned to: its variants "vector16", "vector4" and "vector1"
(csrc/gather_rows.cu), chosen from the operands' alignment alone.

The particle filter's device-gated resample calls it with a gate in
device memory and a given output: on a gate of 0 every block returns at
once and the output keeps its bits.

`gather_rows` sends a CUDA tensor to the kernel and a CPU tensor to
`gather_rows_plain`; anything else raises.
"""

from __future__ import annotations

import torch

from slam2d_tpu_torch.ops import _build

VARIANTS = ("vector16", "vector4", "vector1")  # the C layer's codes


def gather_rows_plain(x, ancestors, gate=None, out=None):
    """Plain PyTorch version of the kernel (into `out` where given: its
    old rows where the gate is 0)."""
    rows = x.index_select(0, ancestors.to(torch.int64))
    if out is None:
        return rows
    return out.copy_(_build.gated(gate, rows, out))


def gather_rows(x, ancestors, plain: bool = False, gate=None, out=None):
    """x[ancestors] for a [P, ...] tensor `x` and int32 `ancestors` [P]
    in [0, P), as a fresh tensor or into `out` (x's shape and dtype, not
    x itself). `gate`, a one-element bool tensor on x's device (None:
    always), is read there: a gate of 0 writes nothing, so `out` keeps its
    bits. `plain=True` runs the plain version on a CUDA tensor too, for
    checks of the kernel only."""
    if x.dim() < 1 or not 1 <= x.shape[0] <= 65535:
        raise ValueError(f"x must be [P, ...] with 1 <= P <= 65535, got "
                         f"{tuple(x.shape)}")
    P = x.shape[0]
    if ancestors.dtype != torch.int32 or tuple(ancestors.shape) != (P,):
        raise ValueError(
            f"ancestors must be int32 of shape ({P},), got {ancestors.dtype} "
            f"{tuple(ancestors.shape)}"
        )
    if ancestors.device != x.device:
        raise ValueError(f"ancestors are on {ancestors.device}, x on {x.device}")
    if not (x.is_contiguous() and ancestors.is_contiguous()):
        raise ValueError("x and ancestors must be contiguous")
    _build.check_gate(gate, x.device)
    if out is not None and (
        out.shape != x.shape or out.dtype != x.dtype or out.device != x.device
        or not out.is_contiguous() or out.data_ptr() == x.data_ptr()
    ):
        raise ValueError("out must be a contiguous tensor of x's shape, "
                         "dtype and device, other than x")
    if plain or x.device.type == "cpu":
        return gather_rows_plain(x, ancestors, gate, out)
    if x.device.type != "cuda":
        raise ValueError(f"no gather kernel for device {x.device}")
    if out is None:
        out = torch.empty_like(x)
    lib = _build.load_library()
    err = lib.slam2d_gather_rows(
        x.data_ptr(), out.data_ptr(), ancestors.data_ptr(), P,
        x.numel() // P * x.element_size(), _build.gate_ptr(gate),
        _build.stream_handle(x.device),
    )
    _build.check(err, "slam2d_gather_rows")
    gather_rows.launches += 1
    return out


def last_variant() -> str:
    """The kernel variant that the last launch of `gather_rows` ran."""
    return VARIANTS[_build.load_library().slam2d_gather_rows_last_variant()]


gather_rows.launches = 0
