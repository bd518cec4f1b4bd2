"""Float32 rounding rules the port shares with the JAX package as compiled.

XLA compiles a division by a constant, `x / c`, as a multiplication by the
constant's float32 reciprocal, `x * fl(1 / c)`. The JAX package divides by
config constants (the cell size, the evidence saturation) inside jitted
code, so the port multiplies by the same reciprocal: a cell index or a
fractional position then rounds as in the reference, and an endpoint that
lies exactly on a cell edge lands in the same cell.

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


@contextlib.contextmanager
def highest_matmul_precision():
    """float32 matmuls in full float32 (TF32 off) for the block."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)
