"""Float32 rounding rules the port shares with the JAX package as compiled.

XLA compiles a division by a constant, `x / c`, as a multiplication by the
constant's float32 reciprocal, `x * fl(1 / c)`. The JAX package divides by
config constants (the cell size, the evidence saturation) inside jitted
code, so the port multiplies by the same reciprocal: a cell index or a
fractional position then rounds as in the reference, and an endpoint that
lies exactly on a cell edge lands in the same cell.

Jitted XLA on the CPU also contracts a float32 multiply-add into one
fused rounding (`fma_f32`). The reference update kernel computes a cell's
bearing with its own polynomial arctangent, whose Horner steps XLA
contracts in the same way (`atan2_ref`). Both are built from IEEE float
operations alone, so they give the same bits on the CPU and on the card,
where `torch.atan2` rounds as each device's math library does.

The JAX package's solvers run under `default_matmul_precision("highest")`;
`highest_matmul_precision` keeps float32 matmuls in full float32 (TF32 off)
for a block of the port's code in the same way.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch


def inv_f32(c: float) -> float:
    """fl32(1 / fl32(c)), the factor XLA multiplies by for `x / c`."""
    return float(np.float32(1.0) / np.float32(c))


def _f64(x):
    if isinstance(x, torch.Tensor):
        return x.double()
    return float(np.float32(x))


def fma_f32(a, b, c):
    """fl32(a * b + c) with one rounding, as XLA contracts a float32
    multiply-add on the CPU: the product of two float32 values is exact in
    float64, so the sum rounds once to float64 and once to float32 (the
    two agree but for a sum on a float32 midpoint). Python numbers count
    as their float32 values."""
    return (_f64(a) * _f64(b) + _f64(c)).float()


# slam2d_tpu/ops/pallas_update.py:_atan_01, a minimax arctangent on [0, 1]
_ATAN_01 = (0.9999993329, -0.3332985605, 0.1994653599, -0.1390853351,
            0.0964200441, -0.0559098861, 0.0218612288, -0.0040540580)


def atan2_ref(y, x):
    """The reference update kernel's atan2 (pallas_update.py:_atan2) of
    float32 tensors, as XLA compiles it on the CPU: the polynomial on
    q = min(|x|, |y|) / max(|x|, |y|, 1e-20), each Horner step one FMA,
    then folded into (-pi, pi]. Within ~2e-8 of the true angle; it is the
    bearing kernel 1 `hybrid` tests against the beam slots, bit for bit
    the reference's on both devices (csrc/common.cuh: atan2_ref)."""
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


@contextlib.contextmanager
def highest_matmul_precision():
    """float32 matmuls in full float32 (TF32 off) for the block."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)
