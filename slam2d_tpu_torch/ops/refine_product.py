"""The shared refine's product: every particle's field against every shift
of every endpoint splat.

Kernel: csrc/refine_product.cu. It replaces no Pallas kernel: the JAX
package leaves this product to XLA (slam2d_tpu/pf/shared_refine.py, a dot
of the bf16 operands with a float32 result). For the fields Sp [P, K] and
the shift stack [N, K] (N = G*R*C, K = win^2),

    raw[p, n] = (sum_k Sp[p, k] * stack[n, k]) / denom

in float32, zeros where the gate is false. bf16 products are exact in
float32; the kernel sums them in float32 in the order of the float32
library product of the plain version (K in slices, each summed column by
column, the slices in order: see the kernel's source), skipping the
stack's zero columns, and so gives the same bits as the library at the
refine shapes of the port's FastSLAM paths on the H100 (`_slices`), on
every run.

`refine_product` sends bf16 CUDA operands to the kernel. float32 operands,
CPU operands and `plain=True` take `refine_product_plain` (on CUDA a
float32 library product). Anything else raises.
"""

from __future__ import annotations

import torch

from slam2d_tpu_torch.core.numerics import highest_matmul_precision
from slam2d_tpu_torch.ops import _build

_DTYPES = (torch.float32, torch.bfloat16)


def refine_product_plain(Sp, stack, denom, gate=None):
    """Plain PyTorch version: both operands widened to float32, their
    product in full float32 (TF32 off), `/ denom`, zeros where the gate is
    false."""
    with highest_matmul_precision():
        raw = Sp.to(torch.float32) @ stack.to(torch.float32).T
    return _build.gated(gate, raw / denom, 0.0)


# the kernel's tiles (csrc/refine_product.cu): TILE_K columns of K, bands
# of BAND rows of the stack
_TILE_K, _BAND = 8, 64


def _slices(device, M: int, N: int, K: int) -> int:
    """The kernel's slices of K for an [M, N] output: the split of the
    float32 library product, whose bits the kernel then gives (see the
    kernel's source). On the H100 cuBLAS's SIMT GEMM deals K to as many
    slices as two blocks an SM over its 128 x 128 output tiles (probed at
    [250, 375], [1000, 375] and [100, 3211]), or one block an SM over 128
    x 64 tiles at an output of at most 128 x 384 (probed at FastSLAM-100's
    [100, 375]). Where the library takes another kernel (below 64 rows)
    the same count only fills the SMs. At least 1, at most K's tiles."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    if M <= 128 and N <= 384:
        blocks, tiles = sms, -(-N // 128) * -(-M // 64)
    else:
        blocks, tiles = 2 * sms, -(-N // 128) * -(-M // 128)
    return max(1, min(-(-K // _TILE_K), blocks // tiles))


def refine_product(Sp, stack, denom, gate=None, plain: bool = False):
    """raw [P, N] float32 of Sp [P, K] and stack [N, K] (see the module
    docstring), both bf16 or both float32, contiguous, on one device with
    `denom`, a one-element float32 tensor. `gate`, a one-element bool
    tensor there (None: always), is read on the device: zeros where it is
    false. `plain=True` runs the plain version on a CUDA tensor too, for
    checks of the kernel only."""
    if Sp.dim() != 2 or stack.dim() != 2 or Sp.shape[1] != stack.shape[1]:
        raise ValueError(f"need Sp [P, K] and stack [N, K], got "
                         f"{tuple(Sp.shape)} and {tuple(stack.shape)}")
    if min(*Sp.shape, stack.shape[0]) < 1:
        raise ValueError(f"empty operand: {tuple(Sp.shape)}, "
                         f"{tuple(stack.shape)}")
    if Sp.dtype not in _DTYPES or stack.dtype != Sp.dtype:
        raise ValueError(f"operands must be both float32 or both bfloat16, "
                         f"got {Sp.dtype} and {stack.dtype}")
    if not (Sp.is_contiguous() and stack.is_contiguous()):
        raise ValueError("Sp and stack must be contiguous")
    if stack.device != Sp.device or denom.device != Sp.device:
        raise ValueError("Sp, stack and denom must be on one device")
    if denom.dtype != torch.float32 or denom.numel() != 1:
        raise ValueError("denom must be a one-element float32 tensor")
    _build.check_gate(gate, Sp.device)
    if Sp.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no refine-product kernel for device {Sp.device}")
    if plain or Sp.device.type == "cpu" or Sp.dtype == torch.float32:
        return refine_product_plain(Sp, stack, denom, gate)
    (M, K), N = Sp.shape, stack.shape[0]
    S = _slices(Sp.device, M, N, K)
    ws = torch.empty((S, M, N), dtype=torch.float32, device=Sp.device)
    masks = torch.empty((-(-N // _BAND), -(-K // _TILE_K)), dtype=torch.uint8,
                        device=Sp.device)
    out = torch.empty((M, N), dtype=torch.float32, device=Sp.device)
    err = _build.load_library().slam2d_refine_product(
        Sp.data_ptr(), stack.data_ptr(), ws.data_ptr(), masks.data_ptr(),
        out.data_ptr(), denom.data_ptr(), M, N, K, S, _build.gate_ptr(gate),
        _build.stream_handle(Sp.device),
    )
    _build.check(err, "slam2d_refine_product")
    refine_product.launches += 1
    return out


refine_product.launches = 0
