"""The least time a kernel's work needs on the card: bytes at the HBM rate
or operations at the float32 rate, whichever is larger.

A frozen copy, at commit fe37ab964ea616f84f82d44417eea1bff9015b6b, of
chip_smoke.py's bound arithmetic (`_bound`, `score_bound`, and the
bytes and operations it counts for kernel 1 `hybrid` in place, kernel 3
in place, kernel 1 `ism`, kernel 6 and kernel 4), with the published
peaks of one H100 SXM (NVIDIA's data sheet, at 700 W): 3.35 TB/s of HBM
and 67 TFLOP/s in float32 outside the tensor cores (no hand kernel of the
port runs on the tensor cores). Each function counts one launch whose
gate passed: every input byte read once and every output byte written
once, whatever the kernel reads again. A launch whose gate is 0 needs its
gate read alone (`GATE_BYTES`).
"""

from __future__ import annotations

import torch

PEAKS = {  # substring of torch.cuda.get_device_name -> (bytes/s, f32 op/s)
    "H100": (3.35e12, 67e12),
}
GATE_BYTES = 1


def peaks(device_name: str):
    """(HBM bytes/s, float32 operations/s) of the card, or None."""
    for key, value in PEAKS.items():
        if key in device_name:
            return value
    return None


def bound_s(n_bytes: float, n_ops: float, device_name: str):
    """Seconds: the larger of the bytes at the HBM rate and the
    operations at the float32 rate (None for a card not in PEAKS)."""
    p = peaks(device_name)
    if p is None:
        return None
    return max(n_bytes / p[0], n_ops / p[1])


def update_hybrid_work(n_cells: int, n_beams: int):
    """(bytes, operations) of kernel 1 `hybrid` on an n_cells window in
    place: the window read and written once, the scan and its angles,
    the pose, the gate and the origin; ~30 operations a cell."""
    return 2 * n_cells * 4 + 8 * n_beams + 12 + 9, 30 * n_cells


def search_space_work(n_cells: int, kept: int, n_taps: int):
    """(bytes, operations) of kernel 3 in place: the window read once, the
    kept cells written once; two blur passes and ~8 more operations a
    kept cell."""
    return n_cells * 4 + kept * 4 + 9, kept * (4 * n_taps + 8)


def update_ism_work(P: int, n_cells: int, elem_bytes: int, n_beams: int):
    """(bytes, operations) of kernel 1 `ism` over P windows of n_cells:
    every window read and written once in the map dtype, the scan and the
    poses; ~30 operations a cell."""
    return (2 * P * n_cells * elem_bytes + 4 * n_beams + 12 * P,
            30 * P * n_cells)


def window_field_work(P: int, win: int, in_bytes: int, out_bytes: int,
                      n_taps: int):
    """(bytes, operations) of kernel 6: the P windows' map cells read once
    (all counted on the map), the fields written once; two blur passes and
    ~8 more operations a cell."""
    cells = P * win * win
    return cells * in_bytes + cells * out_bytes, cells * (4 * n_taps + 8)


def gather_rows_work(distinct: int, P: int, row_bytes: int):
    """(bytes, operations) of kernel 4: the distinct ancestor rows read
    once, P rows written, the ancestors read."""
    return (distinct + P) * row_bytes + 4 * P, 0


def score_work(S_shape, pos_row, pos_col, valid, n: int, bilinear: bool):
    """(bytes, operations) of kernel 2 on one pass: the distinct cells of
    S under the valid beams' taps read once (a beam's (n + 1)^2 patch from
    floor(pos) when bilinear, else its n^2 patch around round(pos); cells
    inside S only), the positions and `valid` read once, the scores
    written once; 2 operations a tap, valid beam and candidate."""
    T, B = pos_row.shape
    H, W = S_shape
    span = n + 1 if bilinear else n
    offs = torch.arange(span, device=pos_row.device) - n // 2
    base = [(torch.floor(p) if bilinear else torch.round(p))[:, valid].long()
            for p in (pos_row, pos_col)]
    rows = base[0][..., None, None] + offs[:, None]
    cols = base[1][..., None, None] + offs[None, :]
    rows, cols = torch.broadcast_tensors(rows, cols)
    inside = (rows >= 0) & (rows < H) & (cols >= 0) & (cols < W)
    cells = torch.unique(rows[inside] * W + cols[inside]).numel()
    nv = int(valid.sum())
    return (cells * 4 + 2 * T * B * 4 + B + T * n * n * 4,
            T * n * n * nv * 2 * (4 if bilinear else 1))
