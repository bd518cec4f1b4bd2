"""Log-odds updates of a map window from one scan.

Kernels: csrc/update_hybrid.cu, csrc/update_ism.cu and csrc/update_ray.cu,
the ports of slam2d_tpu/ops/pallas_update.py:_update_kernel, variants
"hybrid" (the frontend's update), "ism" (the particle filter's) and "ray"
(the frontend's update_impl="pallas_ray"). The contract is
`pallas_dense_update(..., variant=...)`:

- a cell is FREE if some beam b has the cell's bearing within half a beam
  step of b's angle and the cell is nearer than rmin3[b] - res, where
  rmin3[b] is the min valid range of b and its two neighbours (ends
  replicated);
- "hybrid": it gains l_occ once for every hitting beam whose floor-exact
  endpoint cell it is (the counts stack);
- "ism": it is OCCUPIED if some hitting beam b has the cell's bearing
  within 0.75 * res / d of b's angle and |d - r_b| <= 0.75 * res (the
  beam's arc), and gains l_occ once;
- "ray": free is the sum over beams of the beam's chord through the cell
  square, truncated at r_free, weighted by 1 / max(res, r_free /
  ray_samples) (`ray_tables`); occ counts the hitting beams whose
  floor-exact endpoint cell it is;
- out = clip(g + (l_free * free + l_occ * occ) * enable, +-l_clamp),
  in float32, stored in the map's dtype.

`update_hybrid`, `update_hybrid_window`, `update_hybrid_particles`,
`update_ism`, `update_ray` and `update_ray_particles` send a CUDA tensor
to the kernel and a CPU tensor to their plain versions; anything else
raises. `update_hybrid_window` is the frontend step's form of kernel 1
`hybrid`: in place on a window of the map whose origin and gate lie in
device memory. `update_hybrid_particles` and `update_ray_particles` are
the particle filter's forms of kernels 1 `hybrid` and `ray`: every
particle's window of a [P, H, W] map stack in one launch (a grid axis
over the particles, as kernel 1 `ism` has), each window placed around
its particle's pose as `window_origins` says. `update_ism` and the
particle forms take the particle filter's device gate (`gate=`, a bool
tensor on the maps' device): on 0 every block returns at once and the
maps keep their bits. `update_ray_window` and `update_ism` with
`origin=` are kernel 1 `ray`'s and `ism`'s forms of the frontend step,
as `update_hybrid_window` is `hybrid`'s. With `cell=` in place of
`origin=`, each of the three takes a map that is itself the window (the
tiled frontend's window, gathered from its tile pool), `cell` its
top-left cell on the lattice, which places its float origin alone.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from slam2d_tpu_torch.core.numerics import atan2_ref, fma_f32, inv_f32
from slam2d_tpu_torch.grid.window import (
    check_window_operands,
    put_window,
    take_window,
    window_origin_xy_t,
)
from slam2d_tpu_torch.ops import _build

_MAX_BEAMS = 2048  # beam tables of this length fit the kernels' 48 KB smem


def update_hybrid_plain(
    grid, pose, ranges, angles, *, origin_xy, resolution, step, angle_min,
    min_range, max_range, l_free, l_occ, l_clamp, enable=1.0,
):
    """Plain PyTorch version of the kernel, same float32 operations. The
    cell centre is one FMA and the bearing is `atan2_ref`, as XLA compiles
    the reference kernel on the CPU, so a cell's bearing has the same bits
    on the CPU and on the card.

    The free test needs only the two beams whose slots can hold the
    cell's bearing, floor(phi / step) and the next one: any other beam is
    at least a whole step away, so checking those two is exactly the
    reference's test against every beam."""
    H, W = grid.shape
    B = ranges.shape[0]
    dev = grid.device
    ox, oy = origin_xy
    r = torch.clamp(ranges, 0.0, max_range)
    valid = (ranges > min_range) & torch.isfinite(ranges)
    hit = valid & (ranges < max_range)
    rv = torch.where(valid, r, math.inf)
    rmin3 = torch.minimum(
        rv,
        torch.minimum(
            torch.cat([rv[:1], rv[:-1]]), torch.cat([rv[1:], rv[-1:]])
        ),
    )
    rmin3 = torch.where(valid & torch.isfinite(rmin3), rmin3, -1.0)

    col = torch.arange(W, dtype=torch.float32, device=dev)
    row = torch.arange(H, dtype=torch.float32, device=dev)
    cx = (fma_f32(col + 0.5, resolution, ox) - pose[0])[None, :].expand(H, W)
    cy = (fma_f32(row + 0.5, resolution, oy) - pose[1])[:, None].expand(H, W)
    d = torch.sqrt(cx * cx + cy * cy)
    phi = atan2_ref(cy, cx) - pose[2] - angle_min
    phi = torch.remainder(phi + math.pi, 2 * math.pi) - math.pi
    k0 = torch.floor(phi / step)
    free = torch.zeros((H, W), dtype=torch.bool, device=dev)
    for k in (k0, k0 + 1):
        kb = torch.clamp(k, 0, B - 1).to(torch.int64)
        ab = kb.to(torch.float32) * step
        free |= (
            (k >= 0) & (k <= B - 1)
            & (torch.abs(phi - ab) <= 0.5 * step)
            & (d < rmin3[kb] - resolution)
        )

    a = angles + pose[2]
    inv_res = inv_f32(resolution)
    ecol = torch.floor((pose[0] + torch.cos(a) * r - ox) * inv_res)
    erow = torch.floor((pose[1] + torch.sin(a) * r - oy) * inv_res)
    on = hit & (erow >= 0) & (erow < H) & (ecol >= 0) & (ecol < W)
    idx = torch.where(on, erow * W + ecol, 0.0).to(torch.int64)
    count = torch.zeros(H * W, dtype=torch.float32, device=dev)
    count.index_put_((idx,), on.to(torch.float32), accumulate=True)

    upd = (l_free * free.to(torch.float32) + l_occ * count.view(H, W)) * enable
    return torch.clamp(grid + upd, -l_clamp, l_clamp)


def _check(grid, pose, ranges, angles):
    dev = grid.device
    if grid.dim() != 2 or grid.dtype != torch.float32:
        raise ValueError(
            f"grid must be a 2-D float32 tensor, got {grid.dtype} "
            f"{tuple(grid.shape)}"
        )
    B = ranges.shape[0] if ranges.dim() == 1 else -1
    for name, t, shape in (
        ("pose", pose, (3,)), ("ranges", ranges, (B,)), ("angles", angles, (B,))
    ):
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(
                f"{name} must be float32 of shape {shape}, got {t.dtype} "
                f"{tuple(t.shape)}"
            )
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, grid on {dev}")
    for name, t in (
        ("grid", grid), ("pose", pose), ("ranges", ranges), ("angles", angles)
    ):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not 1 <= B <= _MAX_BEAMS:
        raise ValueError(f"need 1..{_MAX_BEAMS} beams, got {B}")


def update_hybrid(
    grid, pose, ranges, angles, *, origin_xy, resolution, step, angle_min,
    min_range, max_range, l_free, l_occ, l_clamp, enable=1.0, plain=False,
):
    """Updated copy of `grid` [H, W] f32 after one scan from `pose` [3].

    `ranges` [B] and `angles` [B] (the float32 beam-angle table) lie on
    the grid's device; `origin_xy` is the float world origin of cell
    (0, 0). The other arguments are the sensor and grid constants.
    `plain=True` runs the plain version on a CUDA tensor too: it is meant
    for checks of the kernel against it, not for use."""
    _check(grid, pose, ranges, angles)
    kw = dict(
        origin_xy=origin_xy, resolution=resolution, step=step,
        angle_min=angle_min, min_range=min_range, max_range=max_range,
        l_free=l_free, l_occ=l_occ, l_clamp=l_clamp, enable=enable,
    )
    if plain or grid.device.type == "cpu":
        return update_hybrid_plain(grid, pose, ranges, angles, **kw)
    if grid.device.type != "cuda":
        raise ValueError(f"no update kernel for device {grid.device}")
    H, W = grid.shape
    out = torch.empty_like(grid)
    lib = _build.load_library()
    err = lib.slam2d_update_hybrid(
        grid.data_ptr(), out.data_ptr(), pose.data_ptr(), ranges.data_ptr(),
        angles.data_ptr(), H, W, ranges.shape[0],
        origin_xy[0], origin_xy[1], resolution, step, angle_min, min_range,
        max_range, l_free, l_occ, l_clamp, enable,
        _build.stream_handle(grid.device),
    )
    _build.check(err, "slam2d_update_hybrid")
    update_hybrid.launches += 1
    return out


update_hybrid.launches = 0


def window_operands(grid, origin, cell, gate, size):
    """Check the operands of a window form (grid/window.py:
    check_window_operands; `cell`, which excludes `origin`, is checked as
    an origin and needs a window the size of the map) and return the
    kernel's (origin pointer, origin_in_map)."""
    check_window_operands(grid, origin, gate, size)
    if cell is None:
        return (None if origin is None else origin.data_ptr()), 1
    if origin is not None or tuple(size) != tuple(grid.shape):
        raise ValueError("cell= takes no origin and a window the size of "
                         "the map")
    check_window_operands(grid, cell, None, size)
    return cell.data_ptr(), 0


def window_plain(grid, update, *, origin, cell, size, gate, origin_xy,
                 resolution):
    """The plain version of a window form, in place: the window gathered at
    the device origin (the map itself with `cell`), `update(window, float
    origin)` at its float origin (as window_origin_xy rounds it), and the
    window written back selected by the gate (a gate of 0 writes the old
    cells back: the same bits)."""
    ox, oy = origin_xy
    if origin is not None:
        g = take_window(grid, origin, size)
        origin_xy = tuple(window_origin_xy_t(ox, oy, resolution, origin))
    elif cell is not None:
        g = grid
        origin_xy = tuple(window_origin_xy_t(ox, oy, resolution, cell))
    else:
        g = grid[: size[0], : size[1]]
    new = _build.gated(gate, update(g, origin_xy), g)
    if origin is not None:
        return put_window(grid, new, origin)
    grid[: size[0], : size[1]] = new
    return grid


def update_hybrid_window(
    grid, pose, ranges, angles, *, origin, size, gate, origin_xy,
    resolution, step, angle_min, min_range, max_range, l_free, l_occ,
    l_clamp, enable=1.0, cell=None, plain=False,
):
    """Kernel 1 `hybrid` in place on the (h, w) = `size` window of `grid`
    [H, W] f32 whose top-left cell is the int32 device tensor `origin`
    (r0, c0) (None: the map's cell (0, 0)), when the bool device tensor
    `gate` is true (None: always); `origin_xy` is the float world origin
    of the map's cell (0, 0). The window's cells get the bits of
    extract_window -> update_hybrid at window_origin_xy -> write_window;
    a gate of 0 leaves the map bit-identical. `cell` (with no origin and
    a window the size of the map): the map is the window, `cell` its
    top-left cell on the lattice of `origin_xy`. One launch; nothing is
    read back to the host. Returns `grid`."""
    _check(grid, pose, ranges, angles)
    ptr, in_map = window_operands(grid, origin, cell, gate, size)
    if plain or grid.device.type == "cpu":
        return window_plain(
            grid, lambda g, o: update_hybrid_plain(
                g, pose, ranges, angles, origin_xy=o, resolution=resolution,
                step=step, angle_min=angle_min, min_range=min_range,
                max_range=max_range, l_free=l_free, l_occ=l_occ,
                l_clamp=l_clamp, enable=enable),
            origin=origin, cell=cell, size=tuple(size), gate=gate,
            origin_xy=origin_xy, resolution=resolution)
    if grid.device.type != "cuda":
        raise ValueError(f"no update kernel for device {grid.device}")
    H, W = grid.shape
    lib = _build.load_library()
    err = lib.slam2d_update_hybrid_window(
        grid.data_ptr(), ptr, in_map, _build.gate_ptr(gate), pose.data_ptr(),
        ranges.data_ptr(), angles.data_ptr(), H, W, size[0], size[1],
        ranges.shape[0], origin_xy[0], origin_xy[1], resolution, step,
        angle_min, min_range, max_range, l_free, l_occ, l_clamp, enable,
        _build.stream_handle(grid.device),
    )
    _build.check(err, "slam2d_update_hybrid_window")
    update_hybrid.launches += 1
    return grid


def _beam_tables(ranges, min_range, max_range):
    """(r_hit, rmin3) [B]: a hitting beam's clipped range (else -1), and
    the min valid clipped range of each beam and its two neighbours
    (else -1), as the TPU kernel's wrapper builds them."""
    r = torch.clamp(ranges, 0.0, max_range)
    valid = (ranges > min_range) & torch.isfinite(ranges)
    r_hit = torch.where(valid & (ranges < max_range), r, -1.0)
    rv = torch.where(valid, r, math.inf)
    rmin3 = torch.minimum(
        rv,
        torch.minimum(
            torch.cat([rv[:1], rv[:-1]]), torch.cat([rv[1:], rv[-1:]])
        ),
    )
    return r_hit, torch.where(valid & torch.isfinite(rmin3), rmin3, -1.0)


def window_origins(poses, region, shape, origin_xy, resolution):
    """Each particle's update window: integer top-left cells [P] x 2 (the
    pose's cell minus half the window, clamped into the map, as
    grid/window.py:window_origin does) and float world origins [P] x 2
    (ox + f32(c0) * res, as integrate_scan derives them)."""
    (Hr, Wr), (H, W) = region, shape
    inv_res = inv_f32(resolution)
    cr = torch.floor((poses[:, 1] - origin_xy[1]) * inv_res).to(torch.int64)
    cc = torch.floor((poses[:, 0] - origin_xy[0]) * inv_res).to(torch.int64)
    r0 = torch.clamp(cr - Hr // 2, 0, H - Hr)
    c0 = torch.clamp(cc - Wr // 2, 0, W - Wr)
    ox = origin_xy[0] + c0.to(torch.float32) * resolution
    oy = origin_xy[1] + r0.to(torch.float32) * resolution
    return (r0, c0), (ox, oy)


def _ism_windows(poses, region, shape, origin_xy, resolution, origin=None,
                 cell=None):
    """`window_origins`, or with a device `origin` [2] (one map) the
    window at it, or with `cell` the whole map at that lattice cell: the
    integer top-left cells [P] x 2 in the map and the float origins [P] x
    2."""
    o = origin if cell is None else cell
    if o is None:
        return window_origins(poses, region, shape, origin_xy, resolution)
    f = window_origin_xy_t(origin_xy[0], origin_xy[1], resolution,
                           o.reshape(1, 2))
    rc = o.to(torch.int64).reshape(1, 2)
    if cell is not None:
        rc = torch.zeros_like(rc)
    return (rc[:, 0], rc[:, 1]), (f[:, 0], f[:, 1])


def ism_cell_polar(poses, region, shape, *, origin_xy, resolution,
                   angle_min, origin=None, cell=None):
    """(d, phi) [P, Hr, Wr] float32: the range and the bearing (relative to
    angle_min, wrapped to [-pi, pi)) of every cell center of each
    particle's `region` window, placed as `window_origins` says (or at
    `origin` / `cell`, as `update_ism` takes them), with the kernel's
    float32 operations as XLA compiles them on the CPU: the centre one
    FMA, the bearing `atan2_ref` (see update_hybrid_plain)."""
    Hr, Wr = region
    dev = poses.device
    _, (ox, oy) = _ism_windows(poses, region, shape, origin_xy, resolution,
                               origin, cell)
    col = torch.arange(Wr, dtype=torch.float32, device=dev)
    row = torch.arange(Hr, dtype=torch.float32, device=dev)
    px, py, pth = (poses[:, i, None, None] for i in range(3))
    cx = fma_f32((col + 0.5)[None, None, :], resolution,
                 ox[:, None, None]) - px
    cy = fma_f32((row + 0.5)[None, :, None], resolution,
                 oy[:, None, None]) - py
    d = torch.sqrt(cx * cx + cy * cy)
    P = poses.shape[0]
    phi = atan2_ref(cy.expand(P, Hr, Wr), cx.expand(P, Hr, Wr))
    phi = phi - pth - angle_min
    return d, torch.remainder(phi + math.pi, 2 * math.pi) - math.pi


def ism_occ_tol(resolution) -> float:
    """The occupied channel's range tolerance, float32(0.75 * res)."""
    return float(np.float32(0.75 * resolution))


def update_ism_plain(
    maps, poses, ranges, *, region, origin_xy, resolution, step, angle_min,
    min_range, max_range, l_free, l_occ, l_clamp, enable=1.0, gate=None,
    origin=None, cell=None,
):
    """Plain PyTorch version of the kernel, same float32 operations, in
    place. The occupied test loops over every beam, as the TPU kernel
    does; the free test checks the two beams whose slots can hold the
    cell's bearing (see update_hybrid_plain). A gate of 0 writes the old
    cells back: the same bits."""
    P, H, W = maps.shape
    Hr, Wr = region
    B = ranges.shape[0]
    dev = maps.device
    (r0, c0), _ = _ism_windows(poses, region, (H, W), origin_xy, resolution,
                               origin, cell)
    pidx = torch.arange(P, device=dev)[:, None, None]
    rows = (r0[:, None] + torch.arange(Hr, device=dev))[:, :, None]
    cols = (c0[:, None] + torch.arange(Wr, device=dev))[:, None, :]
    old = maps[pidx, rows, cols]
    g = old.to(torch.float32)                               # [P, Hr, Wr]

    r_hit, rmin3 = _beam_tables(ranges, min_range, max_range)
    d, phi = ism_cell_polar(
        poses, region, (H, W), origin_xy=origin_xy, resolution=resolution,
        angle_min=angle_min, origin=origin, cell=cell,
    )
    k0 = torch.floor(phi / step)
    free = torch.zeros_like(d, dtype=torch.bool)
    for k in (k0, k0 + 1):
        kb = torch.clamp(k, 0, B - 1).to(torch.int64)
        free |= (
            (k >= 0) & (k <= B - 1)
            & (torch.abs(phi - kb.to(torch.float32) * step) <= 0.5 * step)
            & (d < rmin3[kb] - resolution)
        )
    occ_tol = ism_occ_tol(resolution)
    # a true division (a Python number over a tensor would be rounded
    # twice, through the tensor's reciprocal)
    tol = torch.full_like(d, occ_tol) / torch.clamp(d, min=1e-6)
    ab = torch.arange(B, dtype=torch.float32, device=dev) * step
    occ = torch.zeros_like(free)
    for b in range(B):
        occ |= (torch.abs(phi - ab[b]) <= tol) & (
            torch.abs(d - r_hit[b]) <= occ_tol
        )

    upd = (l_free * free.to(torch.float32) + l_occ * occ.to(torch.float32))
    out = torch.clamp(g + upd * enable, -l_clamp, l_clamp)
    maps[pidx, rows, cols] = _build.gated(gate, out.to(maps.dtype), old)
    return maps


_ISM_BOX = 6  # the kernel's candidate box side, cells (BOX, update_ism.cu)


def ism_occ_boxes(poses, ranges, region, shape, *, origin_xy, resolution,
                  step, angle_min, min_range, max_range):
    """The kernel's candidate boxes of the occupied channel: (top-left
    window cells [P, B, 2] int64 (row, col) of each beam's _ISM_BOX^2 box,
    [P, B] bool: the beam can mark a cell at all).

    A cell that beam b marks (|phi - b*step| <= tol = occ_tol / max(d,
    1e-6), |d - r_b| <= occ_tol) has its center within |d - r_b| + d * tol
    <= 2 * occ_tol of b's endpoint, a chord being no longer than its arc,
    whatever the wrap of phi (the reference's polynomial bearing lies
    within ~2e-8 rad of the true one: d * 2e-8 m, far inside the slack
    below). The box holds the cells whose centers lie
    within 2 * occ_tol / res + 1 cells of the endpoint along each axis:
    one cell of slack for the rounding of the endpoint (the kernel's fast
    sine and cosine). A beam can mark only if -r_b <= occ_tol (r_b is -1
    for a beam that does not hit)."""
    dev = poses.device
    B = ranges.shape[0]
    _, (ox, oy) = window_origins(poses, region, shape, origin_xy, resolution)
    r_hit, _ = _beam_tables(ranges, min_range, max_range)
    occ_tol = ism_occ_tol(resolution)
    inv_res = inv_f32(resolution)
    beam = torch.arange(B, dtype=torch.float32, device=dev)
    a = poses[:, 2:3] + angle_min + beam * step                   # [P, B]
    ex = (poses[:, 0:1] + r_hit * torch.cos(a) - ox[:, None]) * inv_res - 0.5
    ey = (poses[:, 1:2] + r_hit * torch.sin(a) - oy[:, None]) * inv_res - 0.5
    half = 2.0 * occ_tol * inv_res + 1.0
    top_left = torch.stack(
        [torch.ceil(ey - half), torch.ceil(ex - half)], dim=-1
    ).to(torch.int64)
    return top_left, (-r_hit <= occ_tol).expand(poses.shape[0], B)


def _check_ism(maps, poses, ranges, region):
    dev = maps.device
    if maps.dim() != 3 or maps.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(
            "maps must be a [P, H, W] float32 or bfloat16 tensor, got "
            f"{maps.dtype} {tuple(maps.shape)}"
        )
    P, H, W = maps.shape
    B = ranges.shape[0] if ranges.dim() == 1 else -1
    for name, t, shape in (("poses", poses, (P, 3)), ("ranges", ranges, (B,))):
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(
                f"{name} must be float32 of shape {shape}, got {t.dtype} "
                f"{tuple(t.shape)}"
            )
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, maps on {dev}")
    for name, t in (("maps", maps), ("poses", poses), ("ranges", ranges)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not 1 <= B <= _MAX_BEAMS:
        raise ValueError(f"need 1..{_MAX_BEAMS} beams, got {B}")
    if not (1 <= region[0] <= H and 1 <= region[1] <= W):
        raise ValueError(f"window {region} does not fit maps of {H}x{W}")
    if not 1 <= P <= 65535:
        raise ValueError(f"need 1..65535 maps, got {P}")


def update_ism(
    maps, poses, ranges, *, region, origin_xy, resolution, step, angle_min,
    min_range, max_range, l_free, l_occ, l_clamp, enable=1.0, gate=None,
    origin=None, cell=None, plain=False,
):
    """Integrate one scan into every particle's map, IN PLACE; returns
    `maps` [P, H, W] (float32 or bfloat16).

    Particle p's scan is taken from `poses[p]`; it updates the
    `region` = (Hr, Wr) window of maps[p] around that pose, placed as
    `window_origins` says (a region the size of the map is the whole map).
    `origin_xy` is the float world origin of cell (0, 0) of the maps. The
    other arguments are the sensor and grid constants. `gate`, a
    one-element bool tensor on the maps' device (None: always), is read
    there: a gate of 0 leaves the maps bit-identical, with nothing read
    back to the host. The frontend step's form (one float32 map): a device
    `origin` [2] places the window instead of the pose, and `cell` takes
    the whole map as a window at that lattice cell (update_hybrid_window's
    operands). `plain=True` runs the plain version on a CUDA tensor
    too: it is meant for checks of the kernel against it, not for use."""
    _check_ism(maps, poses, ranges, region)
    _build.check_gate(gate, maps.device)
    if origin is not None or cell is not None:
        if maps.shape[0] != 1 or maps.dtype != torch.float32:
            raise ValueError("a window origin takes one float32 map")
        ptr, in_map = window_operands(maps[0], origin, cell, gate, region)
    kw = dict(
        region=region, origin_xy=origin_xy, resolution=resolution, step=step,
        angle_min=angle_min, min_range=min_range, max_range=max_range,
        l_free=l_free, l_occ=l_occ, l_clamp=l_clamp, enable=enable, gate=gate,
        origin=origin, cell=cell,
    )
    if plain or maps.device.type == "cpu":
        return update_ism_plain(maps, poses, ranges, **kw)
    if maps.device.type != "cuda":
        raise ValueError(f"no update kernel for device {maps.device}")
    P, H, W = maps.shape
    f32 = lambda x: float(np.float32(x))  # noqa: E731
    lib = _build.load_library()
    if origin is not None or cell is not None:
        err = lib.slam2d_update_ism_window(
            maps.data_ptr(), ptr, in_map, poses.data_ptr(), ranges.data_ptr(),
            H, W, region[0], region[1], ranges.shape[0], origin_xy[0],
            origin_xy[1], resolution, inv_f32(resolution), step,
            f32(0.5 * f32(step)), angle_min, min_range, max_range,
            ism_occ_tol(resolution), l_free, l_occ, l_clamp, enable,
            _build.gate_ptr(gate), _build.stream_handle(maps.device),
        )
        _build.check(err, "slam2d_update_ism_window")
        update_ism.launches += 1
        return maps
    err = lib.slam2d_update_ism(
        maps.data_ptr(), int(maps.dtype == torch.bfloat16), poses.data_ptr(),
        ranges.data_ptr(), P, H, W, region[0], region[1], ranges.shape[0],
        origin_xy[0], origin_xy[1], resolution, inv_f32(resolution), step,
        f32(0.5 * f32(step)), angle_min, min_range, max_range,
        ism_occ_tol(resolution), l_free, l_occ, l_clamp, enable,
        _build.gate_ptr(gate), _build.stream_handle(maps.device),
    )
    _build.check(err, "slam2d_update_ism")
    update_ism.launches += 1
    return maps


update_ism.launches = 0


_RAY_UNROLL = 8        # the TPU kernel's beam chunk: sums group by 8 beams
_RAY_TILE = (8, 16)    # the kernel's cell tile (rows, columns): a block
_MAX_RAY_BEAMS = 1360  # 9 f32 tables of this length fit 48 KB of smem
_RAY_PLAIN_TERMS = 1 << 24  # (cell, beam) terms the plain version takes at once


def ray_tables(pose, ranges, angles, *, origin_xy, resolution, min_range,
               max_range, ray_samples):
    """[9, Bpad] float32 beam tables of the exact-ray update, rows (dirx,
    diry, w_free, cmax, half, invab, r_free, erow, ecol), padded to a
    multiple of 8 beams that cannot fire (zero weight, endpoints at
    -1e9), built with the float32 operations of the TPU kernel's wrapper
    (pallas_update.py:321-370; a division by a config constant as the
    multiplication by its float32 reciprocal, as XLA compiles it).
    `angles` is the float32 cast of the float64 beam-angle table. The
    kernel builds the same tables with the same operations in its
    prologue; this is their plain version."""
    res = resolution
    r = torch.clamp(ranges, 0.0, max_range)
    valid = (ranges > min_range) & torch.isfinite(ranges)
    hit = valid & (ranges < max_range)
    a = angles + pose[2]
    dirx, diry = torch.cos(a), torch.sin(a)
    r_free = torch.clamp_min(r - res, 0.0) * valid
    spacing = r_free * inv_f32(max(ray_samples, 1))
    w_free = valid / torch.clamp_min(spacing, res)
    adx, ady = dirx.abs(), diry.abs()
    amax, amin = torch.maximum(adx, ady), torch.minimum(adx, ady)
    cmax = torch.full_like(amax, res) / torch.clamp_min(amax, 1e-6)
    half = (0.5 * res) * (adx + ady)
    invab = 1.0 / torch.clamp_min(amax * amin, 1e-9)
    inv_res = inv_f32(res)
    ecol = torch.floor((pose[0] + dirx * r - origin_xy[0]) * inv_res)
    erow = torch.floor((pose[1] + diry * r - origin_xy[1]) * inv_res)
    ecol = torch.where(hit, ecol, -1e9)
    erow = torch.where(hit, erow, -1e9)
    rays = torch.stack(
        [dirx, diry, w_free, cmax, half, invab, r_free, erow, ecol]
    )
    pad = (-rays.shape[1]) % _RAY_UNROLL
    if pad:
        fill = torch.zeros((9, pad), dtype=torch.float32, device=rays.device)
        fill[7:] = -1e9
        rays = torch.cat([rays, fill], dim=1)
    return rays.contiguous()


def ray_chunk_bounds(pose, ranges, shape, *, origin_xy, resolution,
                     min_range, max_range, angle_min, step):
    """[ceil(H / TY), ceil(W / TX), 2] int64: for each of the kernel's
    (TY, TX) = _RAY_TILE tiles of the map window `shape` = (H, W), the
    chunks [c_lo, c_hi) of 8 beams that can touch it, as the kernel
    computes them (the TPU kernel's angular beam-range clip and range
    early-out, pallas_update.py:141-174).

    A tile's cell centers span a rectangle seen from the sensor. Beam b
    (at b * step from angle_min + pose[2]) adds a nonzero chord only to a
    cell within res / sqrt(2) of its line in front of the sensor, and
    marks only the cell holding its endpoint, so only beams within
    asin(res / (sqrt(2) d)) of a cell's bearing at distance d touch it.
    The rectangle's bearing interval (from its corners) widened by
    max(step / 2, 0.75 res / d_min) + step / 4 holds every such beam once
    d_min >= 2 res; nearer tiles take every chunk. A tile farther than the
    scan's largest valid range + 0.75 res takes none; so does one that no
    beam looks at. An interval that meets the beam range both as it is
    and a turn away (a sensor of ~360 degrees) takes every chunk."""
    H, W = shape
    ty, tx = _RAY_TILE
    B = ranges.shape[0]
    n_chunks = -(-B // _RAY_UNROLL)
    dev = ranges.device
    res = resolution
    ox, oy = origin_xy

    def centers(n, t, o, s):
        lo = torch.arange(0, n, t, dtype=torch.float32, device=dev)
        hi = torch.clamp_max(lo + t, n) - 1
        return fma_f32(lo + 0.5, res, o) - s, fma_f32(hi + 0.5, res, o) - s

    x0, x1 = (c[None, :] for c in centers(W, tx, ox, pose[0]))
    y0, y1 = (c[:, None] for c in centers(H, ty, oy, pose[1]))
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    ex = torch.where(x0 > 0, x0, torch.where(x1 < 0, -x1, zero))
    ey = torch.where(y0 > 0, y0, torch.where(y1 < 0, -y1, zero))
    d_min = torch.sqrt(ex * ex + ey * ey)
    valid = (ranges > min_range) & torch.isfinite(ranges)
    r = torch.clamp(ranges, 0.0, max_range)
    rmax = torch.where(valid, r, -1.0).max()
    untouched = d_min > rmax + 0.75 * res
    near = d_min < 2.0 * res

    mid = torch.atan2(0.5 * (y0 + y1), 0.5 * (x0 + x1))
    deltas = []
    for y in (y0, y1):
        for x in (x0, x1):
            d = torch.atan2(y, x) - mid
            deltas.append(torch.where(
                d > math.pi, d - 2 * math.pi,
                torch.where(d < -math.pi, d + 2 * math.pi, d),
            ))
    deltas = torch.stack(torch.broadcast_tensors(*deltas))
    dlo = torch.clamp_max(deltas.amin(0), 0.0)
    dhi = torch.clamp_min(deltas.amax(0), 0.0)
    wide = (dhi - dlo) > math.pi
    thr = torch.clamp_min(0.75 * res / d_min, 0.5 * step) + 0.25 * step
    u = mid - pose[2] - angle_min
    u = u - 2 * math.pi * torch.floor(u / (2 * math.pi))
    span = _RAY_UNROLL * step
    last = (B - 1) * step
    found = torch.zeros_like(u, dtype=torch.int64)
    lo = torch.zeros_like(found)
    hi = torch.zeros_like(found)
    for k in (-1, 0, 1):
        a = u + dlo - thr + 2 * math.pi * k
        b = u + dhi + thr + 2 * math.pi * k
        c_lo = torch.clamp_min(torch.floor(a / span), 0).to(torch.int64)
        c_hi = torch.clamp_max(torch.floor(b / span) + 1, n_chunks).to(
            torch.int64
        )
        ok = (b >= 0) & (a <= last) & (c_hi > c_lo)
        found += ok
        lo = torch.where(ok, c_lo, lo)
        hi = torch.where(ok, c_hi, hi)
    all_ = torch.full_like(found, n_chunks)
    lo = torch.where(found == 1, lo, 0)
    hi = torch.where(found == 1, hi, torch.where(found > 1, all_, 0))
    lo = torch.where(near | wide, 0, lo)
    hi = torch.where(near | wide, all_, hi)
    lo = torch.where(untouched, 0, lo)
    hi = torch.where(untouched, 0, hi)
    return torch.stack([lo, hi], dim=-1)


def update_ray_plain(grid, pose, rays, *, origin_xy, resolution, l_free,
                     l_occ, l_clamp, enable=1.0, bounds=None):
    """Plain PyTorch version of the kernel, the same float32 operations in
    the same order (chunks of 8 beams, each summed from its first beam,
    then added to the total), with the FMAs XLA contracts in the reference
    kernel on the CPU: the cell centre, t = fma(cx, dx, cy*dy), cx*dy -
    cy*dx = fma(cx, dy, -(cy*dx)), and a chunk's sum fma(w0, c0, w1*c1),
    then fma(wk, ck, sum). The beams' terms are evaluated for a group of
    chunks at once (_RAY_PLAIN_TERMS cells x beams on CUDA, a quarter of
    it on the CPU), each term by itself, so the grouping changes no bit.

    `bounds` (`ray_chunk_bounds` of the same window) sums, in each tile,
    only its chunks [c_lo, c_hi), as the kernel does; None sums every
    chunk. The skipped terms are zeros, so both give the same bits."""
    H, W = grid.shape
    dev = grid.device
    ox, oy = origin_xy
    col = torch.arange(W, dtype=torch.float32, device=dev)
    row = torch.arange(H, dtype=torch.float32, device=dev)
    cx = (fma_f32(col + 0.5, resolution, ox) - pose[0])[None, :]
    cy = (fma_f32(row + 0.5, resolution, oy) - pose[1])[:, None]
    rowg, colg = row[:, None], col[None, :]
    if bounds is not None:
        lo, hi = (
            bounds[..., i].repeat_interleave(_RAY_TILE[0], 0)[:H]
            .repeat_interleave(_RAY_TILE[1], 1)[:, :W]
            for i in (0, 1)
        )
    free = torch.zeros((H, W), dtype=torch.float32, device=dev)
    occ = torch.zeros((H, W), dtype=torch.float32, device=dev)
    n_chunks = rays.shape[1] // _RAY_UNROLL
    terms = _RAY_PLAIN_TERMS if dev.type == "cuda" else _RAY_PLAIN_TERMS // 4
    group = max(1, terms // (_RAY_UNROLL * H * W))
    for g0 in range(0, n_chunks, group):
        g = min(group, n_chunks - g0)
        dx, dy, w, cm, hf, ia, rf, er, ec = (
            r.reshape(g, _RAY_UNROLL, 1, 1)
            for r in rays[:, g0 * _RAY_UNROLL : (g0 + g) * _RAY_UNROLL])
        t = fma_f32(cx, dx, cy * dy)                     # [g, 8, H, W]
        ct = torch.abs(fma_f32(cx, dy, -(cy * dx)))
        L = torch.clamp_min(torch.minimum(cm, (hf - ct) * ia), 0.0)
        Lh = 0.5 * L
        chord = torch.clamp_min(
            torch.minimum(t + Lh, rf) - torch.clamp_min(t - Lh, 0.0), 0.0
        )
        o = ((rowg == er) & (colg == ec)).to(torch.float32)
        fa = fma_f32(w[:, 0], chord[:, 0], w[:, 1] * chord[:, 1])
        oa = o[:, 0] + o[:, 1]
        for k in range(2, _RAY_UNROLL):
            fa = fma_f32(w[:, k], chord[:, k], fa)
            oa = oa + o[:, k]
        for j in range(g):
            if bounds is None:
                free = free + fa[j]
                occ = occ + oa[j]
            else:
                take = (lo <= g0 + j) & (g0 + j < hi)
                free = torch.where(take, free + fa[j], free)
                occ = torch.where(take, occ + oa[j], occ)
    upd = (l_free * free + l_occ * occ) * enable
    return torch.clamp(grid + upd, -l_clamp, l_clamp)


def update_ray(
    grid, pose, ranges, angles, *, origin_xy, resolution, min_range,
    max_range, angle_min, step, l_free, l_occ, l_clamp, ray_samples,
    enable=1.0, plain=False,
):
    """Updated copy of `grid` [H, W] f32 after one scan from `pose` [3],
    by the exact-ray update (module docstring).

    `ranges` [B] and `angles` [B] (the float32 beam-angle table, beam b at
    angle_min + b * step) lie on the grid's device; `origin_xy` is the
    float world origin of cell (0, 0). On a CUDA tensor this is one
    kernel: it builds the beam tables and finds each tile's chunks
    itself. The plain version reads the tables from `ray_tables` and sums
    every chunk. `plain=True` runs the plain version on a CUDA tensor too:
    it is meant for checks of the kernel, not for use."""
    _check(grid, pose, ranges, angles)
    if ranges.shape[0] > _MAX_RAY_BEAMS:
        raise ValueError(f"need at most {_MAX_RAY_BEAMS} beams")
    if plain or grid.device.type == "cpu":
        rays = ray_tables(
            pose, ranges, angles, origin_xy=origin_xy, resolution=resolution,
            min_range=min_range, max_range=max_range, ray_samples=ray_samples,
        )
        return update_ray_plain(
            grid, pose, rays, origin_xy=origin_xy, resolution=resolution,
            l_free=l_free, l_occ=l_occ, l_clamp=l_clamp, enable=enable,
        )
    if grid.device.type != "cuda":
        raise ValueError(f"no update kernel for device {grid.device}")
    H, W = grid.shape
    out = torch.empty_like(grid)
    lib = _build.load_library()
    err = lib.slam2d_update_ray(
        grid.data_ptr(), out.data_ptr(), pose.data_ptr(), ranges.data_ptr(),
        angles.data_ptr(), H, W, ranges.shape[0], origin_xy[0], origin_xy[1],
        resolution, min_range, max_range, inv_f32(max(ray_samples, 1)),
        0.5 * resolution, inv_f32(resolution), angle_min, step, l_free,
        l_occ, l_clamp, enable, _build.stream_handle(grid.device),
    )
    _build.check(err, "slam2d_update_ray")
    update_ray.launches += 1
    return out


update_ray.launches = 0


def update_ray_window(
    grid, pose, ranges, angles, *, origin, size, gate, origin_xy,
    resolution, min_range, max_range, angle_min, step, l_free, l_occ,
    l_clamp, ray_samples, enable=1.0, cell=None, plain=False,
):
    """Kernel 1 `ray` in place on the (h, w) = `size` window of `grid`
    [H, W] f32 at the int32 device origin `origin` (None: the map's cell
    (0, 0)), when the bool device tensor `gate` is true (None: always):
    the window's cells get the bits of extract_window -> update_ray at
    window_origin_xy -> write_window, and a gate of 0 leaves the map
    bit-identical; `cell` as for update_hybrid_window. One launch; nothing
    is read back to the host. Returns `grid`."""
    _check(grid, pose, ranges, angles)
    if ranges.shape[0] > _MAX_RAY_BEAMS:
        raise ValueError(f"need at most {_MAX_RAY_BEAMS} beams")
    ptr, in_map = window_operands(grid, origin, cell, gate, size)
    if plain or grid.device.type == "cpu":
        def one(g, o):
            rays = ray_tables(
                pose, ranges, angles, origin_xy=o, resolution=resolution,
                min_range=min_range, max_range=max_range,
                ray_samples=ray_samples,
            )
            return update_ray_plain(
                g, pose, rays, origin_xy=o, resolution=resolution,
                l_free=l_free, l_occ=l_occ, l_clamp=l_clamp, enable=enable,
            )
        return window_plain(grid, one, origin=origin, cell=cell,
                            size=tuple(size), gate=gate, origin_xy=origin_xy,
                            resolution=resolution)
    if grid.device.type != "cuda":
        raise ValueError(f"no update kernel for device {grid.device}")
    H, W = grid.shape
    lib = _build.load_library()
    err = lib.slam2d_update_ray_window(
        grid.data_ptr(), ptr, in_map, _build.gate_ptr(gate), pose.data_ptr(),
        ranges.data_ptr(), angles.data_ptr(), H, W, size[0], size[1],
        ranges.shape[0], origin_xy[0], origin_xy[1], resolution, min_range,
        max_range, inv_f32(max(ray_samples, 1)), 0.5 * resolution,
        inv_f32(resolution), angle_min, step, l_free, l_occ, l_clamp, enable,
        _build.stream_handle(grid.device),
    )
    _build.check(err, "slam2d_update_ray_window")
    update_ray.launches += 1
    return grid


def _check_particles(maps, poses, ranges, angles, region):
    _check_ism(maps, poses, ranges, region)
    if (angles.dtype != torch.float32 or tuple(angles.shape) != ranges.shape
            or angles.device != maps.device or not angles.is_contiguous()):
        raise ValueError("angles must be a contiguous float32 [B] tensor on "
                         "the maps' device")


def _per_particle_plain(update_one, maps, poses, region, origin_xy,
                        resolution, gate=None):
    """The plain version of a particle-batched update: `update_one(window
    [Hr, Wr] float32, pose [3], window origin (x, y))` on each particle's
    window in turn (placed by `window_origins`), written back IN PLACE in
    the maps' dtype (the old cells where `gate` is 0: the same bits)."""
    Hr, Wr = region
    (r0, c0), (ox, oy) = window_origins(
        poses, region, maps.shape[1:], origin_xy, resolution)
    for p, (r, c, x, y) in enumerate(zip(r0.tolist(), c0.tolist(),
                                         ox.tolist(), oy.tolist())):
        win = maps[p, r : r + Hr, c : c + Wr]
        new = update_one(win.to(torch.float32).contiguous(), poses[p], (x, y))
        win.copy_(_build.gated(gate, new.to(maps.dtype), win))
    return maps


def update_hybrid_particles(
    maps, poses, ranges, angles, *, region, origin_xy, resolution, step,
    angle_min, min_range, max_range, l_free, l_occ, l_clamp, enable=1.0,
    gate=None, plain=False,
):
    """Kernel 1 `hybrid` on every particle's map, IN PLACE; returns `maps`
    [P, H, W] (float32 or bfloat16, updated in float32).

    Particle p's scan is taken from `poses[p]`; it updates the `region` =
    (Hr, Wr) window of maps[p] placed around that pose as `window_origins`
    says (a region the size of the map is the whole map), with the bits of
    `update_hybrid` on that window at its float origin ox + f32(c0) * res.
    `angles` [B] is the float32 beam-angle table. One launch for all the
    particles; `gate` as for `update_ism`. The plain version loops over
    the particles with `update_hybrid_plain`; `plain=True` runs it on a
    CUDA tensor too (for checks)."""
    _check_particles(maps, poses, ranges, angles, region)
    _build.check_gate(gate, maps.device)
    kw = dict(resolution=resolution, step=step, angle_min=angle_min,
              min_range=min_range, max_range=max_range, l_free=l_free,
              l_occ=l_occ, l_clamp=l_clamp, enable=enable)
    if plain or maps.device.type == "cpu":
        return _per_particle_plain(
            lambda g, pose, o: update_hybrid_plain(
                g, pose, ranges, angles, origin_xy=o, **kw),
            maps, poses, region, origin_xy, resolution, gate)
    if maps.device.type != "cuda":
        raise ValueError(f"no update kernel for device {maps.device}")
    P, H, W = maps.shape
    lib = _build.load_library()
    err = lib.slam2d_update_hybrid_particles(
        maps.data_ptr(), int(maps.dtype == torch.bfloat16), poses.data_ptr(),
        ranges.data_ptr(), angles.data_ptr(), P, H, W, region[0], region[1],
        ranges.shape[0], origin_xy[0], origin_xy[1], resolution, step,
        angle_min, min_range, max_range, l_free, l_occ, l_clamp, enable,
        _build.gate_ptr(gate), _build.stream_handle(maps.device),
    )
    _build.check(err, "slam2d_update_hybrid_particles")
    update_hybrid_particles.launches += 1
    return maps


update_hybrid_particles.launches = 0


def update_ray_particles(
    maps, poses, ranges, angles, *, region, origin_xy, resolution, min_range,
    max_range, angle_min, step, l_free, l_occ, l_clamp, ray_samples,
    enable=1.0, gate=None, plain=False,
):
    """Kernel 1 `ray` on every particle's map, IN PLACE; returns `maps`
    [P, H, W] (float32 or bfloat16, updated in float32): particle p's
    window placed around `poses[p]` as in `update_hybrid_particles`, with
    the bits of `update_ray` on that window at its float origin. One
    launch for all the particles; `gate` as for `update_ism`. The plain
    version loops over the particles with `ray_tables` and
    `update_ray_plain`; `plain=True` runs it on a CUDA tensor too (for
    checks)."""
    _check_particles(maps, poses, ranges, angles, region)
    _build.check_gate(gate, maps.device)
    if ranges.shape[0] > _MAX_RAY_BEAMS:
        raise ValueError(f"need at most {_MAX_RAY_BEAMS} beams")
    if plain or maps.device.type == "cpu":
        def one(g, pose, o):
            rays = ray_tables(
                pose, ranges, angles, origin_xy=o, resolution=resolution,
                min_range=min_range, max_range=max_range,
                ray_samples=ray_samples,
            )
            return update_ray_plain(
                g, pose, rays, origin_xy=o, resolution=resolution,
                l_free=l_free, l_occ=l_occ, l_clamp=l_clamp, enable=enable,
            )
        return _per_particle_plain(one, maps, poses, region, origin_xy,
                                   resolution, gate)
    if maps.device.type != "cuda":
        raise ValueError(f"no update kernel for device {maps.device}")
    P, H, W = maps.shape
    lib = _build.load_library()
    err = lib.slam2d_update_ray_particles(
        maps.data_ptr(), int(maps.dtype == torch.bfloat16), poses.data_ptr(),
        ranges.data_ptr(), angles.data_ptr(), P, H, W, region[0], region[1],
        ranges.shape[0], origin_xy[0], origin_xy[1], resolution, min_range,
        max_range, inv_f32(max(ray_samples, 1)), 0.5 * resolution,
        inv_f32(resolution), angle_min, step, l_free, l_occ, l_clamp, enable,
        _build.gate_ptr(gate), _build.stream_handle(maps.device),
    )
    _build.check(err, "slam2d_update_ray_particles")
    update_ray_particles.launches += 1
    return maps


update_ray_particles.launches = 0
