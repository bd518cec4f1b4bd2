"""PyTorch port: the shared refine's product (ops/refine_product.py).

On the CPU: the wrapper's plain version against the product as the shared
refine wrote it before the kernel (both operands widened to float32, a
float32 product with TF32 off, `/ denom`, zeros where the gate is false),
bit for bit, for bf16 and float32 operands; the gate's zeros; the
operand checks.

On a card (marker `cuda`, skipped without one; this file imports no JAX,
so run it with `python -m pytest tests/test_torch_refine_product.py -m
cuda --noconftest`): the kernel against the plain version (there the
float32 library product) at P = 16, 100, 250 and 1000 over the
FastSLAM-100 shapes (N = 375, K = 288^2) with a gate of 1, 0 and None, at
the CLI's FastSLAM-100 shape (N = 3211, K = 544^2), and at small shapes
that reach its edges (K not a multiple of the step or of 8, a misaligned
base, one row). The kernel keeps the library's order of sums where it
knows the library's split (ops/refine_product.py:_slices): at the shapes
of the port's FastSLAM paths the same bits; elsewhere each output is held
to ULPS float32 epsilons of its sum of |products| (over denom). A repeat
run gives the same bits.
"""

import pytest
import torch

from slam2d_tpu_torch.core.numerics import highest_matmul_precision
from slam2d_tpu_torch.ops import refine_product as rp

N = 375          # G * R * C at FastSLAM-100's refine: 15 * 5 * 5
K_SMALL = 200    # no multiple of the kernel's 64-deep steps
K_FULL = 288 * 288
ULPS = 4
# particle counts whose refine shapes take the library's split: FastSLAM-100,
# a rank of sharded FastSLAM-1000, FastSLAM-1000
LIBRARY_SPLIT_P = (100, 250, 1000)


def _operands(P, n, k, dtype, device="cpu", seed=0):
    """Fields in [-1, 1] and a sparse stack of splat weights in [0, 1),
    rounded to `dtype`; denom a float32 count of valid beams."""
    g = torch.Generator().manual_seed(seed)
    Sp = (torch.rand((P, k), generator=g) * 2 - 1).to(dtype)
    w = torch.rand((n, k), generator=g)
    stack = torch.where(torch.rand((n, k), generator=g) < 0.05, w, 0.0)
    denom = torch.tensor(173.0)
    return Sp.to(device), stack.to(dtype).to(device), denom.to(device)


def _before(Sp, stack, denom, gate):
    """The shared refine's product as it was written before the kernel."""
    with highest_matmul_precision():
        raw = Sp.to(torch.float32) @ stack.to(torch.float32).T
    raw = raw / denom
    return raw if gate is None else torch.where(gate.reshape(()), raw, 0.0)


def _gate(value, device="cpu"):
    return None if value is None else torch.tensor([value], device=device)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("gate", [None, True, False])
@pytest.mark.parametrize("P", [16, 100])
def test_plain_equals_the_product_before(P, gate, dtype):
    Sp, stack, denom = _operands(P, N, K_SMALL, dtype)
    g = _gate(gate)
    out = rp.refine_product(Sp, stack, denom, gate=g)
    assert out.dtype == torch.float32 and out.shape == (P, N)
    assert torch.equal(out, _before(Sp, stack, denom, g))


def test_gate_zero_gives_zeros():
    Sp, stack, denom = _operands(16, N, K_SMALL, torch.bfloat16)
    Sp[3, 5] = float("nan")
    stack[7, 9] = float("inf")
    out = rp.refine_product(Sp, stack, denom, gate=_gate(False))
    assert torch.equal(out, torch.zeros_like(out))
    assert not torch.signbit(out).any()


def _bad(case):
    Sp, stack, denom = _operands(4, 24, 40, torch.bfloat16)
    kw = {}
    if case == "dtype":
        Sp, stack = Sp.half(), stack.half()
    elif case == "mixed_dtypes":
        stack = stack.float()
    elif case == "rank":
        Sp = Sp.reshape(4, 5, 8)
    elif case == "depth":
        stack = stack[:, :32].contiguous()
    elif case == "empty":
        Sp = Sp[:0]
    elif case == "not_contiguous":
        stack = stack.T.contiguous().T
    elif case == "device":
        stack = stack.to("meta")
    elif case == "no_kernel_device":
        Sp, stack, denom = Sp.to("meta"), stack.to("meta"), denom.to("meta")
    elif case == "denom":
        denom = torch.ones(2)
    elif case == "gate":
        kw["gate"] = torch.tensor([1])
    return Sp, stack, denom, kw


@pytest.mark.parametrize("case", [
    "dtype", "mixed_dtypes", "rank", "depth", "empty", "not_contiguous",
    "device", "no_kernel_device", "denom", "gate"])
def test_wrapper_raises(case):
    Sp, stack, denom, kw = _bad(case)
    with pytest.raises(ValueError):
        rp.refine_product(Sp, stack, denom, **kw)


# ---- on a card -------------------------------------------------------------

@pytest.fixture
def cuda():
    """The card, or a skip: decided here, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU form")
    return torch.device("cuda", 0)


def _held(out, Sp, stack, denom, gate):
    """Largest |kernel - plain| in units of ULPS epsilons of each output's
    sum of |products| over denom (<= 1 passes)."""
    ref = rp.refine_product(Sp, stack, denom, gate=gate, plain=True)
    with highest_matmul_precision():
        mag = Sp.float().abs() @ stack.float().abs().T
    tol = ULPS * torch.finfo(torch.float32).eps * mag / denom
    tol = torch.where(tol > 0, tol, torch.finfo(torch.float32).tiny)
    return float(((out - ref).abs() / tol).max())


@pytest.mark.cuda
@pytest.mark.parametrize("gate", [1, 0, None])
@pytest.mark.parametrize("P", [16, 100, 250, 1000])
def test_kernel_against_plain(cuda, P, gate):
    Sp, stack, denom = _operands(P, N, K_FULL, torch.bfloat16, cuda, seed=P)
    g = _gate(None if gate is None else bool(gate), cuda)
    before = rp.refine_product.launches
    out = rp.refine_product(Sp, stack, denom, gate=g)
    again = rp.refine_product(Sp, stack, denom, gate=g)
    torch.cuda.synchronize()
    assert rp.refine_product.launches == before + 2
    assert torch.equal(out, again)
    if gate == 0:
        assert torch.equal(out, torch.zeros_like(out))
        assert not torch.signbit(out).any()
    else:
        assert _held(out, Sp, stack, denom, g) <= 1.0
    if gate != 0 and P in LIBRARY_SPLIT_P:
        assert torch.equal(out, rp.refine_product(Sp, stack, denom, gate=g,
                                                  plain=True))
    if gate == 1:
        assert torch.equal(out, rp.refine_product(Sp, stack, denom))


@pytest.mark.cuda
def test_kernel_at_the_cli_shape(cuda):
    """The CLI's FastSLAM-100 (1024^2 maps at 0.05 m): the library's bits;
    operands drawn on the card (the stack is 1.9 GB)."""
    P, n, k = 100, 3211, 544 * 544
    g = torch.Generator(device=cuda).manual_seed(7)
    Sp = (torch.rand((P, k), generator=g, device=cuda) * 2 - 1).bfloat16()
    stack = torch.rand((n, k), generator=g, device=cuda)
    stack = torch.where(torch.rand((n, k), generator=g, device=cuda) < 0.005,
                        stack, 0.0).bfloat16()
    denom = torch.tensor([173.0], device=cuda)
    out = rp.refine_product(Sp, stack, denom)
    assert torch.equal(out, rp.refine_product(Sp, stack, denom))
    assert torch.equal(out, rp.refine_product(Sp, stack, denom, plain=True))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,offset", [
    ((1, 8, 64), 0),          # one row, one step
    ((37, 130, 1000), 0),     # K no multiple of 64
    ((129, 257, 8200), 0),    # two m tiles, three n tiles
    ((100, 375, 1003), 0),    # K no multiple of 8: loads value by value
    ((100, 375, 4096), 1),    # a misaligned base: the same
])
def test_kernel_edges(cuda, shape, offset):
    P, n, k = shape
    Sp, stack, denom = _operands(P, n, k, torch.bfloat16, cuda, seed=k)
    if offset:
        buf = torch.empty(P * k + offset, dtype=Sp.dtype, device=cuda)
        buf[offset:] = Sp.reshape(-1)
        Sp = buf[offset:].view(P, k)
    out = rp.refine_product(Sp, stack, denom)
    assert torch.equal(out, rp.refine_product(Sp, stack, denom))
    assert _held(out, Sp, stack, denom, None) <= 1.0


@pytest.mark.cuda
def test_float32_operands_take_the_library_product(cuda):
    Sp, stack, denom = _operands(100, N, K_SMALL, torch.float32, cuda)
    before = rp.refine_product.launches
    out = rp.refine_product(Sp, stack, denom, gate=_gate(True, cuda))
    assert rp.refine_product.launches == before
    assert torch.equal(out, _before(Sp, stack, denom, _gate(True, cuda)))
