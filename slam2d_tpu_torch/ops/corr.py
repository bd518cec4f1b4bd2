"""Lag correlation of endpoint-splat images with a padded search space.

Kernel: csrc/corr.cu, the port of slam2d_tpu/ops/pallas_corr.py:
_corr_kernel (corr_scores_pallas), batched over particles:

    out[p, t, dr*C + dc] = sum_{h,w} f32(E[p, t, h, w]) * Sp[p, h+dr, w+dc]

for E [P, T, H, W] (bfloat16 or float32) and Sp [P, H+R, W+C] float32,
the search space zero-padded on its high sides. One launch scores every
particle and theta. The kernel, its plain version and the TPU kernel sum
in different orders: they agree to float32 summation-order rounding.

`corr_scores` sends a CUDA tensor to the kernel and a CPU tensor to
`corr_scores_plain`; anything else raises.
"""

from __future__ import annotations

import torch

from slam2d_tpu_torch.ops import _build

_SIZES = (1, 3, 5, 7, 9, 11)   # the kernel's R = C template instances


def corr_scores_plain(E, Sp, R: int, C: int):
    """Plain PyTorch version of the kernel: one product and sum per lag."""
    P, T, H, W = E.shape
    e = E.to(torch.float32)
    out = torch.stack(
        [
            (e * Sp[:, None, dr:dr + H, dc:dc + W]).sum(dim=(-2, -1))
            for dr in range(R)
            for dc in range(C)
        ],
        dim=-1,
    )
    return out


def corr_scores(E, Sp, R: int, C: int, plain: bool = False, gate=None):
    """Scores [P, T, R*C] float32 (see the module docstring). `gate`, a
    one-element bool tensor on E's device (None: always), is read there:
    on a gate of 0 the kernel writes nothing and the scores are not to be
    read (the plain version computes them all the same). `plain=True`
    runs the plain version on a CUDA tensor too, for checks of the kernel
    only."""
    if E.dim() != 4 or E.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(
            "E must be a [P, T, H, W] float32 or bfloat16 tensor, got "
            f"{E.dtype} {tuple(E.shape)}"
        )
    P, T, H, W = E.shape
    if Sp.dtype != torch.float32 or tuple(Sp.shape) != (P, H + R, W + C):
        raise ValueError(
            f"Sp must be float32 of shape {(P, H + R, W + C)}, got "
            f"{Sp.dtype} {tuple(Sp.shape)}"
        )
    if Sp.device != E.device:
        raise ValueError(f"Sp is on {Sp.device}, E on {E.device}")
    if not (E.is_contiguous() and Sp.is_contiguous()):
        raise ValueError("E and Sp must be contiguous")
    if R != C or R not in _SIZES:
        raise ValueError(f"need R = C in {_SIZES}, got {R} x {C}")
    if not (1 <= P <= 65535 and 1 <= T <= 65535):
        raise ValueError(f"need 1..65535 particles and thetas, got {P}, {T}")
    _build.check_gate(gate, E.device)
    if plain or E.device.type == "cpu":
        return corr_scores_plain(E, Sp, R, C)
    if E.device.type != "cuda":
        raise ValueError(f"no correlation kernel for device {E.device}")
    lib = _build.load_library()
    out = torch.empty((P, T, R * C), dtype=torch.float32, device=E.device)
    err = lib.slam2d_corr_scores(
        E.data_ptr(), int(E.dtype == torch.bfloat16), Sp.data_ptr(),
        out.data_ptr(), P, T, H, W, R, C, _build.gate_ptr(gate),
        _build.stream_handle(E.device),
    )
    _build.check(err, "slam2d_corr_scores")
    corr_scores.launches += 1
    return out


corr_scores.launches = 0
