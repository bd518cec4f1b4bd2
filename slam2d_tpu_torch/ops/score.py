"""Correlative match scores: the [T, R, C] candidate window of one scan.

Kernel: csrc/score.cu, the port of slam2d_tpu/ops/pallas_score.py:
_score_kernel (on the TPU's frontend path the one-hot matmul scorer
ops/mxu_score.py stood in its place). The contract is the JAX package's
`score_offsets(impl="gather")` (match/correlative.py): per theta and
(drow, dcol) offset in [-radius, radius]^2, the mean over valid beams of
S at the beam endpoint shifted by the offset, bilinear (four taps at
floor(pos)) or rounded (one tap at round(pos), half to even). Each tap
outside S is masked on its own.

`score_window` sends a CUDA tensor to the kernel and a CPU tensor to
`score_window_plain`; anything else raises.
"""

from __future__ import annotations

import torch

from slam2d_tpu_torch.ops import _build

_MAX_BEAMS = 2048  # 5 x 4-byte tables of this length fit 48 KB of smem


def score_window_plain(
    S, pos_row, pos_col, valid, radius: int, bilinear: bool
):
    """Plain PyTorch version, the gather formulation of the JAX package."""
    H, W = S.shape
    offs = torch.arange(
        -radius, radius + 1, dtype=torch.int32, device=S.device
    )
    flat = S.reshape(-1)

    def gather_sum(base_row, base_col, beam_w):
        """Sum_b w_b * S[base_row_b + drow, base_col_b + dcol] -> [T, R, C]."""
        rows = base_row[:, None, :] + offs[None, :, None]    # [T, R, B]
        cols = base_col[:, None, :] + offs[None, :, None]    # [T, C, B]
        in_r = (rows >= 0) & (rows < H)
        in_c = (cols >= 0) & (cols < W)
        rows = torch.clamp(rows, 0, H - 1)
        cols = torch.clamp(cols, 0, W - 1)
        idx = rows[:, :, None, :].long() * W + cols[:, None, :, :].long()
        vals = flat[idx]                                     # [T, R, C, B]
        mask = in_r[:, :, None, :] & in_c[:, None, :, :]
        w = torch.where(mask, beam_w[:, None, None, :], 0.0)
        return torch.sum(vals * w, dim=-1)

    vweight = valid.to(torch.float32)[None, :]               # [1, B]
    denom = torch.clamp(torch.sum(valid.to(torch.float32)), min=1.0)
    if not bilinear:
        base_col = torch.round(pos_col).to(torch.int32)
        base_row = torch.round(pos_row).to(torch.int32)
        ones = torch.ones_like(pos_col)
        return gather_sum(base_row, base_col, vweight * ones) / denom
    c0 = torch.floor(pos_col)
    r0 = torch.floor(pos_row)
    fc = pos_col - c0
    fr = pos_row - r0
    c0 = c0.to(torch.int32)
    r0 = r0.to(torch.int32)
    acc = gather_sum(r0, c0, vweight * (1 - fr) * (1 - fc))
    acc += gather_sum(r0, c0 + 1, vweight * (1 - fr) * fc)
    acc += gather_sum(r0 + 1, c0, vweight * fr * (1 - fc))
    acc += gather_sum(r0 + 1, c0 + 1, vweight * fr * fc)
    return acc / denom


def _check(S, pos_row, pos_col, valid, radius):
    if S.dim() != 2 or S.dtype != torch.float32:
        raise ValueError(
            f"S must be a 2-D float32 tensor, got {S.dtype} {tuple(S.shape)}"
        )
    if pos_row.dim() != 2 or pos_row.shape != pos_col.shape:
        raise ValueError("pos_row / pos_col must both be [T, B]")
    T, B = pos_row.shape
    if pos_row.dtype != torch.float32 or pos_col.dtype != torch.float32:
        raise ValueError("pos_row / pos_col must be float32")
    if valid.dtype != torch.bool or tuple(valid.shape) != (B,):
        raise ValueError(f"valid must be bool of shape ({B},)")
    for name, t in (("pos_row", pos_row), ("pos_col", pos_col), ("valid", valid)):
        if t.device != S.device:
            raise ValueError(f"{name} is on {t.device}, S on {S.device}")
    for name, t in (
        ("S", S), ("pos_row", pos_row), ("pos_col", pos_col), ("valid", valid)
    ):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if radius < 0 or (2 * radius + 1) ** 2 > 1024:
        raise ValueError(f"radius {radius}: need 1..1024 offsets")
    if not 1 <= B <= _MAX_BEAMS or T < 1:
        raise ValueError(f"need 1..{_MAX_BEAMS} beams and T >= 1, got {T}x{B}")


def score_window(
    S, pos_row, pos_col, valid, radius: int, bilinear: bool,
    plain: bool = False,
):
    """Scores [T, 2*radius+1, 2*radius+1] of the endpoint positions.

    S [H, W] float32; pos_row / pos_col [T, B] float32 fractional
    cell-center coordinates of the beam endpoints for each theta, zeroed
    for invalid beams; valid [B] bool. `plain=True` runs the plain
    version on a CUDA tensor too, for checks of the kernel only."""
    _check(S, pos_row, pos_col, valid, radius)
    if plain or S.device.type == "cpu":
        return score_window_plain(S, pos_row, pos_col, valid, radius, bilinear)
    if S.device.type != "cuda":
        raise ValueError(f"no score kernel for device {S.device}")
    H, W = S.shape
    T, B = pos_row.shape
    n = 2 * radius + 1
    out = torch.empty((T, n, n), dtype=torch.float32, device=S.device)
    lib = _build.load_library()
    err = lib.slam2d_score_offsets(
        S.data_ptr(), pos_row.data_ptr(), pos_col.data_ptr(), valid.data_ptr(),
        out.data_ptr(), H, W, T, B, n, n, int(bilinear),
        _build.stream_handle(S.device),
    )
    _build.check(err, "slam2d_score_offsets")
    score_window.launches += 1
    return out


score_window.launches = 0
