"""Block-Thomas factor of the sparse pose-graph solver's chain matrix.

Kernel: csrc/tridiag_factor.cu, the port of
slam2d_tpu/graph/sparse.py:_tridiag_factor (a `lax.scan` over the K
blocks, which XLA compiles; the JAX package has no Pallas kernel for
it): for T = tridiag(O^T, D, O) with [K, 3, 3] diagonal blocks D and
chain off-diagonals O (O[k] the block (k, k+1)),

    C[k] = D[k] - O[k-1]^T C[k-1]^-1 O[k-1],    Cinv[k] = C[k]^-1,

in float32, the 3x3 inverse by cofactors. The recurrence is sequential
in k: as PyTorch it is K steps of small launches; the kernel walks it in
one launch. `tridiag_factor` sends a CUDA tensor to the kernel and a CPU
tensor to `tridiag_factor_plain`; anything else raises.
"""

from __future__ import annotations

import torch

from slam2d_tpu_torch.ops import _build


def _mm(a, b):
    """a @ b of 3x3 tensors as products summed over the middle axis."""
    return (a[:, :, None] * b[None, :, :]).sum(1)


def _mtm(a, b):
    """a^T @ b of 3x3 tensors, as `_mm`."""
    return (a[:, :, None] * b[:, None, :]).sum(0)


_ROT1 = [1, 2, 0]
_ROT2 = [2, 0, 1]


def inv3_cofactor(c):
    """The inverse of a 3x3 tensor by cofactors: with its rows a0, a1, a2,
    [a1 x a2 | a2 x a0 | a0 x a1] (columns) / (a0 . (a1 x a2)), each cross
    product entry u_p v_q - u_q v_p."""
    u, v = c[_ROT1], c[_ROT2]          # rows (a1, a2, a0), (a2, a0, a1)
    x = u[:, _ROT1] * v[:, _ROT2] - u[:, _ROT2] * v[:, _ROT1]
    d = c[0] * x[0]
    return x.T / (d[0] + d[1] + d[2])


def tridiag_factor_plain(D, O):
    """Plain PyTorch version of the kernel: the K-step loop, each step the
    kernel's operations in its order."""
    K = D.shape[0]
    out = torch.empty_like(D)
    cinv = torch.zeros((3, 3), dtype=D.dtype, device=D.device)
    o_prev = torch.zeros_like(cinv)
    for k in range(K):
        c = D[k] - _mtm(o_prev, _mm(cinv, o_prev))
        cinv = inv3_cofactor(c)
        out[k] = cinv
        o_prev = O[k]
    return out


def tridiag_factor(D, O, plain: bool = False):
    """Cinv [K, 3, 3] float32 of the block-tridiagonal T = tridiag(O^T, D,
    O), D and O [K, 3, 3] float32 (O[K-1] is not read). `plain=True` runs
    the plain version on a CUDA tensor too, for checks of the kernel
    only."""
    if D.dim() != 3 or D.shape[1:] != (3, 3) or D.dtype != torch.float32:
        raise ValueError(f"D must be float32 [K, 3, 3], got {D.dtype} "
                         f"{tuple(D.shape)}")
    if O.shape != D.shape or O.dtype != D.dtype or O.device != D.device:
        raise ValueError("O must match D in shape, dtype and device")
    if plain or D.device.type == "cpu":
        return tridiag_factor_plain(D, O)
    if D.device.type != "cuda":
        raise ValueError(f"no tridiagonal factor kernel for device {D.device}")
    D, O = D.contiguous(), O.contiguous()
    out = torch.empty_like(D)
    lib = _build.load_library()
    err = lib.slam2d_tridiag_factor(
        D.data_ptr(), O.data_ptr(), out.data_ptr(), D.shape[0],
        _build.stream_handle(D.device),
    )
    _build.check(err, "slam2d_tridiag_factor")
    tridiag_factor.launches += 1
    return out


tridiag_factor.launches = 0
