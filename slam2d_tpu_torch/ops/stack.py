"""Shift stack of the endpoint splats for the shared-anchor refine.

Kernel: csrc/shift_stack.cu, the port of
slam2d_tpu/ops/pallas_stack.py:_stack_kernel (shift_stack_pallas):

    stack[g, dr*C + dc, h, w] = E[g, h - dr, w - dc]   (0 off the low edge)

for E [G, win, win]; the stack is [G, R*C, win, win] in E's dtype and
bit-exact.

`shift_stack` sends a CUDA tensor to the kernel and a CPU tensor to
`shift_stack_plain`; anything else raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from slam2d_tpu_torch.ops import _build


def shift_stack_plain(E, R: int, C: int):
    """Plain PyTorch version of the kernel: R*C pad-and-crop copies."""
    G, win, _ = E.shape
    return torch.stack(
        [
            F.pad(E, (dc, 0, dr, 0))[:, :win, :win]
            for dr in range(R)
            for dc in range(C)
        ],
        dim=1,
    )


def shift_stack(E, R: int, C: int, plain: bool = False, gate=None):
    """[G, R*C, win, win] shifted copies of E [G, win, win] (see the
    module docstring). `gate`, a one-element bool tensor on E's device
    (None: always), is read there: on a gate of 0 the kernel writes
    nothing and the stack is not to be read (the plain version makes it
    all the same). `plain=True` runs the plain version on a CUDA tensor
    too, for checks of the kernel only."""
    if E.dim() != 3 or E.shape[1] != E.shape[2]:
        raise ValueError(f"E must be [G, win, win], got {tuple(E.shape)}")
    if not E.is_contiguous():
        raise ValueError("E must be contiguous")
    if R < 1 or C < 1:
        raise ValueError(f"need R, C >= 1, got {R}, {C}")
    _build.check_gate(gate, E.device)
    if plain or E.device.type == "cpu":
        return shift_stack_plain(E, R, C)
    if E.device.type != "cuda":
        raise ValueError(f"no shift-stack kernel for device {E.device}")
    G, win, _ = E.shape
    out = torch.empty((G, R * C, win, win), dtype=E.dtype, device=E.device)
    lib = _build.load_library()
    err = lib.slam2d_shift_stack(
        E.data_ptr(), out.data_ptr(), E.element_size(), G, R, C, win,
        _build.gate_ptr(gate), _build.stream_handle(E.device),
    )
    _build.check(err, "slam2d_shift_stack")
    shift_stack.launches += 1
    return out


shift_stack.launches = 0
