"""Float32 rounding rules the port shares with the JAX package as compiled.

XLA compiles a division by a constant, `x / c`, as a multiplication by the
constant's float32 reciprocal, `x * fl(1 / c)`. The JAX package divides by
config constants (the cell size, the evidence saturation) inside jitted
code, so the port multiplies by the same reciprocal: a cell index or a
fractional position then rounds as in the reference, and an endpoint that
lies exactly on a cell edge lands in the same cell.

Jitted XLA on the CPU also contracts a float32 multiply-add into one
fused rounding (`fma_f32`, as a card's fmaf rounds it; `fma_f32_f64` is
its cheaper form for the paths with no kernel). The reference update
kernel computes a cell's bearing with its own polynomial arctangent,
whose Horner steps XLA contracts in the same way (`atan2_ref`). Both
are built from IEEE float operations alone, so they give the same bits
on the CPU and on the card, where `torch.atan2` rounds as each device's
math library does.

The JAX package's solvers run under `default_matmul_precision("highest")`;
`highest_matmul_precision` keeps float32 matmuls in full float32 (TF32 off)
for a block of the port's code in the same way.

The JAX package's dense pose-graph solve factors a float32 matrix with
LAPACK's spotrf on the CPU. cuSOLVER's single-matrix float32 potrf on an
H100 returns a factor about 16x further from the exact one on the pose
graph's normal matrix, which left the port's dense solve ~10x less
accurate than the JAX package's on the serpentine graphs
(scripts/dense_factor_probe_torch.py); `cholesky_f32` takes that factor
on CUDA from a float64 factorization, rounded to float32.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch


def inv_f32(c: float) -> float:
    """fl32(1 / fl32(c)), the factor XLA multiplies by for `x / c`."""
    return float(np.float32(1.0) / np.float32(c))


def _f64(x):
    if isinstance(x, torch.Tensor):
        return x.double()
    return float(np.float32(x))


_F32_LOW = (1 << 29) - 1  # a float64 significand's bits below float32's last
_F32_TIE = 1 << 28        # and their value on a float32 midpoint


def fma_f32(a, b, c):
    """fl32(a * b + c) with one rounding, as XLA contracts a float32
    multiply-add on the CPU (and as the card's fmaf rounds it), for
    results in float32's normal range or zero. The product of two float32
    values is exact in float64, and rounding their float64 sum to float32
    rounds twice only where that sum lies on a float32 midpoint; there
    (one host read finds out) its last bit goes to the odd neighbour on
    the side of the sum's exact error (TwoSum), from which one rounding to
    float32 is the correctly rounded result (53 >= 24 + 2 bits). Python
    numbers count as their float32 values; one of the three must be a
    tensor."""
    p, c = _f64(a) * _f64(b), _f64(c)
    s = p + c
    out = s.float()
    tie = (s.view(torch.int64) & _F32_LOW) == _F32_TIE
    if bool(tie.any()):
        p, c, s = (torch.broadcast_to(torch.as_tensor(x, device=s.device),
                                      s.shape)[tie] for x in (p, c, s))
        t = s - p
        err = (p - (s - t)) + (c - t)
        # err * inf is NaN only where err is 0, where nothing moves
        out[tie] = torch.where(err != 0, torch.nextafter(s, err * math.inf),
                               s).float()
    return out


def fma_f32_f64(a, b, c):
    """fl32(fl64(a * b + c)): fma_f32 in four operations, rounded twice
    where the float64 sum falls on a float32 midpoint. For the paths with
    no kernel of their own (the sampled-ray update), which run it alike
    on both devices and inside CUDA graphs."""
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


def cholesky_f32(A):
    """(L, info) of torch.linalg.cholesky_ex for a float32 matrix A [n, n]:
    on the CPU LAPACK's float32 factor (the JAX package's), on CUDA
    cholesky_via_f64's (module docstring). `info` is nonzero where the
    factor fails, as cholesky_ex's."""
    if A.is_cuda:
        return cholesky_via_f64(A)
    return torch.linalg.cholesky_ex(A)


def cholesky_via_f64(A):
    """(L, info): the float64 Cholesky factor of A rounded to A's dtype."""
    L, info = torch.linalg.cholesky_ex(A.double())
    return L.to(A.dtype), info
