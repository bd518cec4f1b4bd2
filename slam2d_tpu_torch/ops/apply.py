"""Shared-anchor map update apply: slot images and exact endpoint marks
added into every particle's map, in place.

Kernel: csrc/shared_apply.cu, the port of
slam2d_tpu/ops/pallas_apply.py:_apply_kernel (shared_apply_update with
fused endpoints, snapped placement). For particle p, image row 0 sits at
the map cell anchors[p] - win // 2, which may lie off the map:

1. every cell of images[slots[p]] that lands on the map becomes
   clip(f32(x) + img, +-l_clamp), cast to the map dtype; image cells off
   the map are dropped and map cells outside the image are left as they
   are;
2. every cell that is the endpoint cell (ep_rows, ep_cols) of a beam with
   a weight ep_w != 0 gains the float32 sum of those beams' bf16(ep_w)
   (l_occ = 0.85 becomes 0.8515625, on float32 maps too), cast to the map
   dtype, added in the map dtype and clipped to the map dtype's l_clamp.

These are the TPU kernel's numerics: its fused endpoint marks are a bf16
one-hot product with a float32 result, cast, added and clipped in the map
dtype. The JAX package's XLA fallback (a separate endpoint pass) rounds
differently on float32 maps and is not what this computes.

`shared_apply` sends a CUDA tensor to the kernel and a CPU tensor to
`shared_apply_plain`; anything else raises.
"""

from __future__ import annotations

import torch

from slam2d_tpu_torch.ops import _build

_MAX_BEAMS = 4096  # 3 x 4-byte lists of this length: the kernel's smem
_DTYPES = (torch.float32, torch.bfloat16)


def shared_apply_plain(maps, anchors, slots, images, l_clamp, ep_rows=None,
                       ep_cols=None, ep_w=None):
    """Plain PyTorch version of the kernel, same numerics, in place."""
    P, H, W = maps.shape
    win = images.shape[-1]
    dev = maps.device
    ar = torch.arange(win, device=dev)
    rows = (anchors[:, 0:1].to(torch.int64) - win // 2) + ar      # [P, win]
    cols = (anchors[:, 1:2].to(torch.int64) - win // 2) + ar
    on = (
        ((rows >= 0) & (rows < H))[:, :, None]
        & ((cols >= 0) & (cols < W))[:, None, :]
    )
    flat = (
        torch.arange(P, device=dev)[:, None, None] * (H * W)
        + rows.clamp(0, H - 1)[:, :, None] * W
        + cols.clamp(0, W - 1)[:, None, :]
    )[on]
    img = images.index_select(0, slots.to(torch.int64)).to(torch.float32)[on]
    m = maps.view(-1)
    y = torch.clamp(m[flat].to(torch.float32) + img, -l_clamp, l_clamp)
    m[flat] = y.to(maps.dtype)
    if ep_rows is None:
        return maps

    # the marks: each marked cell once, from its first beam, with the
    # float32 sum of its beams' bf16 weights
    w = ep_w.to(torch.bfloat16).to(torch.float32)
    cell = ep_rows.to(torch.int64) * W + ep_cols.to(torch.int64)   # [P, B]
    live = w != 0
    same = (cell[:, :, None] == cell[:, None, :]) & live[:, None, :]
    s = (same.to(torch.float32) * w[:, None, :]).sum(-1)          # [P, B]
    earlier = torch.tril(same, diagonal=-1).any(-1)
    first = live & ~earlier
    pidx = torch.arange(P, device=dev)[:, None].expand_as(cell)
    idx = (pidx * (H * W) + cell)[first]
    t = m[idx] + s[first].to(maps.dtype)
    m[idx] = torch.clamp(t, -l_clamp, l_clamp)
    return maps


def _check(maps, anchors, slots, images, ep):
    if maps.dim() != 3 or maps.dtype not in _DTYPES:
        raise ValueError(
            "maps must be a [P, H, W] float32 or bfloat16 tensor, got "
            f"{maps.dtype} {tuple(maps.shape)}"
        )
    P = maps.shape[0]
    if (images.dim() != 3 or images.dtype not in _DTYPES
            or images.shape[1] != images.shape[2]):
        raise ValueError(
            "images must be a [G, win, win] float32 or bfloat16 tensor, got "
            f"{images.dtype} {tuple(images.shape)}"
        )
    if anchors.dtype != torch.int32 or tuple(anchors.shape) != (P, 2):
        raise ValueError(f"anchors must be int32 of shape ({P}, 2)")
    if slots.dtype != torch.int32 or tuple(slots.shape) != (P,):
        raise ValueError(f"slots must be int32 of shape ({P},)")
    ts = [("anchors", anchors), ("slots", slots), ("images", images)]
    if ep is not None:
        ep_rows, ep_cols, ep_w = ep
        B = ep_rows.shape[-1]
        for name, t, dt in (("ep_rows", ep_rows, torch.int32),
                            ("ep_cols", ep_cols, torch.int32),
                            ("ep_w", ep_w, torch.float32)):
            if t.dtype != dt or tuple(t.shape) != (P, B):
                raise ValueError(f"{name} must be {dt} of shape ({P}, {B})")
            ts.append((name, t))
        if B > _MAX_BEAMS:
            raise ValueError(f"need at most {_MAX_BEAMS} beams, got {B}")
    for name, t in ts:
        if t.device != maps.device:
            raise ValueError(f"{name} is on {t.device}, maps on {maps.device}")
    for name, t in [("maps", maps)] + ts:
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not 1 <= P <= 2**31 - 1:
        raise ValueError(f"bad particle count {P}")


def shared_apply(maps, anchors, slots, images, l_clamp: float, ep_rows=None,
                 ep_cols=None, ep_w=None, plain: bool = False):
    """Add each particle's slot image and endpoint marks into `maps`
    [P, H, W] (float32 or bfloat16) IN PLACE and return it.

    `anchors` [P, 2] int32 (row, col) anchor cells (the image's center cell
    win // 2 lands there), `slots` [P] int32 slot indices into `images`
    [G, win, win] (float32 or bfloat16). `ep_rows`, `ep_cols` [P, B] int32
    and `ep_w` [P, B] float32 are the endpoint marks (None: no marks);
    rows and columns of a beam with w != 0 must lie on the map.
    `plain=True` runs the plain version on a CUDA tensor too, for checks
    of the kernel only."""
    ep = None if ep_rows is None else (ep_rows, ep_cols, ep_w)
    _check(maps, anchors, slots, images, ep)
    if plain or maps.device.type == "cpu":
        return shared_apply_plain(maps, anchors, slots, images, l_clamp,
                                  ep_rows, ep_cols, ep_w)
    if maps.device.type != "cuda":
        raise ValueError(f"no apply kernel for device {maps.device}")
    P, H, W = maps.shape
    G, win, _ = images.shape
    B = 0 if ep is None else ep_rows.shape[1]
    ep_ptrs = [0, 0, 0] if ep is None else [t.data_ptr() for t in ep]
    lib = _build.load_library()
    err = lib.slam2d_shared_apply(
        maps.data_ptr(), int(maps.dtype == torch.bfloat16), images.data_ptr(),
        int(images.dtype == torch.bfloat16), anchors.data_ptr(),
        slots.data_ptr(), *ep_ptrs, P, H, W, win, G, B, l_clamp,
        _build.stream_handle(maps.device),
    )
    _build.check(err, "slam2d_shared_apply")
    shared_apply.launches += 1
    return maps


shared_apply.launches = 0
