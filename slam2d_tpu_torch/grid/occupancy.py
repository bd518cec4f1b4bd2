"""Log-odds occupancy grid as a fixed-shape [H, W] tensor.

Port of slam2d_tpu/grid/occupancy.py: rows = y, cols = x,
world-anchored at GridConfig.origin. Scan integration runs every update
of the JAX package:

- the kernels of ops/update.py: the two that the JAX package resolves
  "auto" to on its accelerator (the hybrid update for the frontend, the
  pure ISM update for the particle filter) and the exact-ray update
  ("pallas_ray");
- the sampled-ray update (`raycast_update`, "sparse"; "sparse_mxu" is
  the same function, which the JAX package accumulates by a one-hot
  matmul on its accelerator): `ray_samples` points a beam, added with
  `index_put_(accumulate=True)` into the flattened map. The JAX package
  resolves "auto" to it off its accelerator, and for a field of view
  wider than pi everywhere;
- the dense inverse sensor model (`raycast_update_dense`, "dense"),
  elementwise PyTorch;
- the endpoint marks alone (`endpoint_update`).

The sampled-ray update reproduces the float32 arithmetic of the JAX
package as XLA compiles it on the CPU: `x / c` as `x * fl32(1 / c)`, and
the multiply-adds `pose + dir * d` contracted into one rounding (`_fma`).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from slam2d_tpu_torch.config import GridConfig, SensorConfig
from slam2d_tpu_torch.core.numerics import fma_f32_f64 as _fma, inv_f32
from slam2d_tpu_torch.ops import _build
from slam2d_tpu_torch.grid.window import window_origin_xy_t
from slam2d_tpu_torch.ops.update import (
    update_hybrid,
    update_hybrid_window,
    update_ism,
    update_ray,
    update_ray_window,
    window_origins,
    window_plain,
)


def make_grid(cfg: GridConfig, device):
    """Fresh all-unknown (log-odds 0) float32 grid on `device`."""
    return torch.zeros((cfg.height, cfg.width), dtype=torch.float32, device=device)


def occupancy_prob(logodds):
    """p(occupied) = 1 - 1/(1+e^l) = sigmoid(l)."""
    return torch.sigmoid(logodds)


def world_to_cell_float(xy, cfg: GridConfig):
    """World (x, y) -> fractional (row, col). Row = y axis, col = x axis."""
    col = (xy[..., 0] - cfg.origin_x) * inv_f32(cfg.resolution)
    row = (xy[..., 1] - cfg.origin_y) * inv_f32(cfg.resolution)
    return torch.stack([row, col], dim=-1)


def world_to_cell(xy, cfg: GridConfig):
    """World (x, y) -> integer (row, col) cell index (not clipped)."""
    return torch.floor(world_to_cell_float(xy, cfg)).to(torch.int32)


def cell_center_world(rc, cfg: GridConfig):
    """Integer (row, col) -> float32 world (x, y) of the cell center."""
    row = rc[..., 0].to(torch.float32)
    col = rc[..., 1].to(torch.float32)
    x = (col + 0.5) * cfg.resolution + cfg.origin_x
    y = (row + 0.5) * cfg.resolution + cfg.origin_y
    return torch.stack([x, y], dim=-1)


@functools.cache
def _sample_fracs(S: int, device):
    """[S] float32 (k + 0.5) / S as XLA folds the JAX package's constant:
    (k + 0.5) * fl32(1 / S)."""
    return (torch.arange(S, dtype=torch.float32, device=device) + 0.5
            ) * inv_f32(S)


@functools.cache
def beam_angles(sensor: SensorConfig, device):
    """[B] float32 beam angles: the float64 SensorConfig table cast once,
    so endpoint cells land exactly where the JAX package puts them.
    Cached per device, so the per-scan path makes no host-to-device copy.
    Callers must not write into it."""
    return torch.as_tensor(
        np.asarray(sensor.beam_angles(), np.float32), device=device
    )


def window_origin_xy(cfg, origin_rc):
    """Float32 world origin (x, y) of a window whose top-left cell is the
    integer `origin_rc` on the lattice of `cfg` (a GridConfig, or a
    grid/tiles TileConfig: anything with origin_x, origin_y and
    resolution), rounded exactly as the JAX package computes it (ox +
    float32(c0) * res, in float32)."""
    r0, c0 = origin_rc
    res = np.float32(cfg.resolution)
    return (
        float(np.float32(cfg.origin_x) + np.float32(c0) * res),
        float(np.float32(cfg.origin_y) + np.float32(r0) * res),
    )


PALLAS_IMPLS = ("pallas", "pallas_ray", "pallas_hybrid")
UPDATE_IMPLS = ("auto", "sparse", "sparse_mxu", "dense") + PALLAS_IMPLS


def _cells(x, o, inv_res, off):
    """floor((x - o) * fl32(1 / res)) - off as int32 (XLA's form of the
    division by the cell size)."""
    return torch.floor((x - o) * inv_res).to(torch.int32) - off


def _beams(pose, ranges, sensor: SensorConfig):
    """(dirx, diry, valid, hit, r_clip) of a scan taken from `pose` [..., 3]:
    the world bearings' cosines and sines [..., B], and [B]: min_range < r
    (finite), hits below max_range, the ranges clipped to it."""
    angles = beam_angles(sensor, ranges.device) + pose[..., 2, None]
    r = ranges.to(torch.float32)
    valid = (r > sensor.min_range) & torch.isfinite(r)
    hit = valid & (r < sensor.max_range)
    return (torch.cos(angles), torch.sin(angles), valid, hit,
            torch.clamp(r, 0.0, sensor.max_range))


def _lead(x, n: int):
    """`x` with n trailing unit axes when it is a tensor of rank > 0 (a
    per-particle value broadcast over beams and samples), else `x`."""
    if isinstance(x, torch.Tensor) and x.dim() > 0:
        return x.reshape(x.shape + (1,) * n)
    return x


def _endpoints(pose, beams, cfg: GridConfig, shape, ox, oy, roff, coff):
    """(row, col, weight) [..., B] of the hits' endpoint cells, relative to
    (roff, coff) (numbers, or [...] tensors for a batch of poses [..., 3]),
    l_occ where the cell lies inside `shape`, else 0 (the cells not yet
    clipped)."""
    dirx, diry, _, hit, r_clip = beams
    H, W = shape
    inv_res = inv_f32(cfg.resolution)
    erow = _cells(_fma(diry, r_clip, pose[..., 1, None]), oy, inv_res,
                  _lead(roff, 1))
    ecol = _cells(_fma(dirx, r_clip, pose[..., 0, None]), ox, inv_res,
                  _lead(coff, 1))
    e_in = (erow >= 0) & (erow < H) & (ecol >= 0) & (ecol < W)
    return erow, ecol, torch.where(hit & e_in, cfg.l_occ, 0.0)


def _raycast_entries(pose, ranges, cfg: GridConfig, sensor: SensorConfig,
                     shape, ox, oy, roff, coff):
    """The sampled-ray update's (row, col, weight) entries before the gate:
    [..., B * S] free samples then [..., B] endpoints, in the JAX package's
    order, the cells relative to (roff, coff) and clipped into `shape`, a
    sample outside it weighing 0 (XLA's scatter with mode="drop" on
    clipped indices). `pose` may be a batch [..., 3], with (roff, coff)
    numbers or [...] tensors."""
    H, W = shape
    res = cfg.resolution
    inv_res = inv_f32(res)
    beams = _beams(pose, ranges, sensor)
    dirx, diry, valid, _, r_clip = beams

    # free-space samples, stopping one cell short of the endpoint
    S = cfg.ray_samples
    r_free = torch.clamp_min(r_clip - res, 0.0)
    d = r_free[:, None] * _sample_fracs(S, ranges.device)[None, :]
    frow = _cells(_fma(diry[..., None], d, pose[..., 1, None, None]), oy,
                  inv_res, _lead(roff, 2))
    fcol = _cells(_fma(dirx[..., None], d, pose[..., 0, None, None]), ox,
                  inv_res, _lead(coff, 2))
    # a traversed cell accumulates about l_free whatever the oversampling:
    # min(r_free / S / res, 1), which XLA folds into one multiplication by
    # fl32(fl32(1 / S) * fl32(1 / res))
    scale = torch.clamp_max(
        r_free * float(np.float32(inv_f32(S)) * np.float32(inv_res)), 1.0)
    free_w = (cfg.l_free * scale * valid)[:, None]
    in_b = (frow >= 0) & (frow < H) & (fcol >= 0) & (fcol < W)
    free_w = torch.where(in_b, free_w, 0.0)

    erow, ecol, occ_w = _endpoints(pose, beams, cfg, shape, ox, oy, roff,
                                   coff)
    lead = erow.shape[:-1]

    def cat(free, occ):
        return torch.cat([free.reshape(lead + (-1,)), occ], dim=-1)

    return (cat(frow, erow).clamp(0, H - 1), cat(fcol, ecol).clamp(0, W - 1),
            cat(free_w, occ_w))


def _origin(cfg: GridConfig, origin_xy, origin_rc):
    """(ox, oy, roff, coff) of a sampled-ray or endpoint update: with
    `origin_rc` the config grid's origin and the integer offset (cells are
    the full grid's floor minus it), else the float origin `origin_xy`
    (default the grid's) and no offset."""
    if origin_rc is not None:
        roff, coff = (v.to(torch.int32) if isinstance(v, torch.Tensor)
                      else int(v) for v in origin_rc)
        return cfg.origin_x, cfg.origin_y, roff, coff
    ox, oy = (cfg.origin_x, cfg.origin_y) if origin_xy is None else origin_xy
    return ox, oy, 0, 0


def _scatter_add_clamp(logodds, rows, cols, w, l_clamp):
    """clip(logodds + scatter-add(w at (rows, cols))) as a new tensor: the
    entries added into the flattened map in index order (a serial loop on
    the CPU; on CUDA a stable sort, each run of equal cells summed and
    then added), then the clamp."""
    H, W = logodds.shape
    flat = logodds.reshape(-1).clone()
    idx = rows.to(torch.int64) * W + cols.to(torch.int64)
    flat.index_put_((idx,), w.to(logodds.dtype), accumulate=True)
    return torch.clamp(flat, -l_clamp, l_clamp).reshape(H, W)


def raycast_update(logodds, pose, ranges, cfg: GridConfig,
                   sensor: SensorConfig, enable=1.0, origin_xy=None,
                   origin_rc=None):
    """The sampled-ray update of one scan taken from `pose` [3] with
    `ranges` [B], into `logodds` [H, W] (the full grid or a window of it);
    returns the updated map, a new tensor.

    Every beam is sampled at cfg.ray_samples points (k + 0.5) / S of its
    range less one cell, each adding l_free * min(spacing / res, 1); a hit
    (min_range < r < max_range) adds l_occ at its endpoint cell; samples
    outside the map add nothing; then the clamp to +-l_clamp. `enable` (0
    or 1, a number or a tensor) multiplies every increment. `origin_xy`
    is the world (x, y) of cell (0, 0) (default the grid's origin);
    `origin_rc`, the window's integer top-left cell (ints or int tensors)
    on the config grid's lattice, takes precedence: the cells are the full
    grid's floor minus it, the bits of the full-grid update."""
    ox, oy, roff, coff = _origin(cfg, origin_xy, origin_rc)
    rows, cols, w = _raycast_entries(pose, ranges, cfg, sensor,
                                     logodds.shape, ox, oy, roff, coff)
    return _scatter_add_clamp(logodds, rows, cols, w * enable, cfg.l_clamp)


def raycast_window(logodds, pose, ranges, cfg: GridConfig,
                   sensor: SensorConfig, *, origin, size, gate, cell=None,
                   origin_xy=None):
    """`raycast_update` in place on the (h, w) = `size` window of the map
    `logodds` [H, W] at the int32 device origin `origin` (None: the map's
    cell (0, 0)), when the bool device tensor `gate` is true: the window's
    cells get the bits of extract_window -> raycast_update(...,
    origin_rc) -> write_window, with nothing read to the host. The
    entries are added into the map in place (a gate of 0 adds -0.0, the
    additive identity, so the map keeps its bits), then the cells they
    touch are clamped (the rest of the window holds clamped values
    already). `cell` (no origin, a window the size of the map): the map is
    a window whose top-left cell on the lattice of world origin
    `origin_xy` (default cfg's) is `cell`, and its cells are floored from
    its float origin, the bits of raycast_update(...,
    origin_xy=window_origin_xy(lattice, cell)). Returns `logodds`."""
    H, W = logodds.shape
    dev = logodds.device
    if cell is not None:
        lx, ly = (cfg.origin_x, cfg.origin_y) if origin_xy is None else origin_xy
        ox, oy = window_origin_xy_t(lx, ly, cfg.resolution, cell)
        origin = torch.zeros(2, dtype=torch.int32, device=dev)
        roff = coff = 0
    else:
        if origin is None:
            origin = torch.zeros(2, dtype=torch.int32, device=dev)
        ox, oy, roff, coff = cfg.origin_x, cfg.origin_y, origin[0], origin[1]
    rows, cols, w = _raycast_entries(pose, ranges, cfg, sensor, size,
                                     ox, oy, roff, coff)
    idx = ((rows + origin[0]).to(torch.int64) * W
           + (cols + origin[1]).to(torch.int64))
    flat = logodds.view(-1)
    flat.index_put_((idx,), torch.where(gate, w, -0.0), accumulate=True)
    v = flat[idx]
    flat[idx] = torch.where(gate, torch.clamp(v, -cfg.l_clamp, cfg.l_clamp),
                            v)
    return logodds


def endpoint_update(logodds, pose, ranges, cfg: GridConfig,
                    sensor: SensorConfig, enable=1.0, origin_rc=None):
    """The endpoint (occupied) marks of the sampled-ray update alone: l_occ
    at each hit's endpoint cell (inside the map), then the clamp. Returns
    a new tensor. `origin_rc` as in `raycast_update`; the float origin is
    the grid's."""
    H, W = logodds.shape
    ox, oy, roff, coff = _origin(cfg, None, origin_rc)
    erow, ecol, w = _endpoints(pose, _beams(pose, ranges, sensor), cfg,
                               (H, W), ox, oy, roff, coff)
    return _scatter_add_clamp(logodds, erow.clamp(0, H - 1),
                              ecol.clamp(0, W - 1), w * enable, cfg.l_clamp)


def raycast_update_dense(logodds, pose, ranges, cfg: GridConfig,
                         sensor: SensorConfig, enable=1.0, origin_xy=None):
    """The classic inverse sensor model evaluated at every cell of
    `logodds` [H, W] (the full grid or a window at `origin_xy`),
    elementwise: a cell's bearing from the pose, wrapped into [0, 2 pi)
    from angle_min (so a 270- or 360-degree scan covers its rear sector),
    picks the nearest beam and its neighbour on the cell's side; the cell
    is free if it lies closer than both returns less a cell, occupied if
    it lies within 0.75 cells of a hit's range and of its ray. A single
    beam is its own ray, half a cell wide. Returns a new tensor of
    `logodds`' dtype, accumulated in float32."""
    ox, oy = (cfg.origin_x, cfg.origin_y) if origin_xy is None else origin_xy
    upd = _dense_increments(pose[0], pose[1], pose[2], ox, oy,
                            logodds.shape, ranges, cfg, sensor)
    out = logodds.to(torch.float32) + upd * enable
    return torch.clamp(out, -cfg.l_clamp, cfg.l_clamp).to(logodds.dtype)


def _dense_increments(px, py, pth, ox, oy, shape, ranges, cfg: GridConfig,
                      sensor: SensorConfig):
    """The dense update's increments (l_free * free + l_occ * occ, float32)
    of the cells of an (H, W) window at the float origin (ox, oy) seen
    from the pose (px, py, pth): numbers or 0-d tensors [H, W] out, or
    [P, 1, 1] tensors for P poses and windows at once, [P, H, W] out."""
    H, W = shape
    dev = ranges.device
    res = cfg.resolution
    B = sensor.n_beams
    r = torch.clamp(ranges.to(torch.float32), 0.0, sensor.max_range)
    beam_valid = (ranges > sensor.min_range) & torch.isfinite(ranges)
    beam_hit = beam_valid & (ranges < sensor.max_range)

    f32 = dict(dtype=torch.float32, device=dev)
    # cell centres relative to the sensor (XLA contracts the multiply-add)
    col = torch.arange(W, **f32)[None, :].expand(H, W)
    row = torch.arange(H, **f32)[:, None].expand(H, W)
    cx = _fma(col + 0.5, res, ox) - px
    cy = _fma(row + 0.5, res, oy) - py
    d = torch.hypot(cx, cy)
    phi = torch.atan2(cy, cx) - pth
    # jnp.mod: fmod, then the divisor added where the signs differ
    two_pi = float(np.float32(2 * math.pi))
    phi = torch.fmod(phi - sensor.angle_min, two_pi)
    phi = torch.where((phi != 0) & (phi < 0), phi + two_pi, phi)
    if B > 1:
        step = sensor.fov_rad / (B - 1)
        k = torch.round(phi * inv_f32(step)).to(torch.int32)
        in_fov = (k >= 0) & (k < B)
        k = torch.clamp(k, 0, B - 1)
    else:
        # the signed wrap: the beam sits at relative bearing 0
        phi = torch.where(phi > math.pi, phi - two_pi, phi)
        step = 1.0
        k = torch.zeros_like(phi, dtype=torch.int32)
        in_fov = (phi.abs() < math.pi / 2) & (phi.abs() * d <= 0.75 * res)

    # the nearest beam and its neighbour on the cell's side: at grazing
    # incidence an endpoint cell's bearing can round to the other one
    resid = phi - k.to(torch.float32) * step
    k2 = torch.clamp(k + torch.where(resid >= 0, 1, -1), 0, B - 1)

    def per_beam(kk):
        kl = kk.to(torch.int64)
        r_b, v_b, h_b = r[kl], beam_valid[kl], beam_hit[kl]
        cross = torch.abs(phi - kk.to(torch.float32) * step) * d
        occ_b = (h_b & (torch.abs(d - r_b) <= 0.75 * res)
                 & (cross <= 0.75 * res))
        return r_b, v_b, occ_b

    r_k, v_k, occ_k = per_beam(k)
    r_k2, v_k2, occ_k2 = per_beam(k2)
    r_min = torch.where(v_k2, torch.minimum(r_k, r_k2), r_k)
    free = in_fov & v_k & (d < r_min - res)
    occ = in_fov & (occ_k | occ_k2)
    return cfg.l_free * free.to(torch.float32) + cfg.l_occ * occ.to(
        torch.float32)


def _particle_windows(maps, poses, cfg: GridConfig, region):
    """((r0, c0) int64 [P] top-left cells, (ox, oy) float32 [P] world
    origins) of each particle's `region` window of `maps` [P, H, W]
    around its pose, as the JAX package's _windowed_update places it
    (extract_window around world_to_cell of the pose)."""
    return window_origins(poses, region, maps.shape[1:],
                          (cfg.origin_x, cfg.origin_y), cfg.resolution)


def raycast_update_particles(maps, poses, ranges, cfg: GridConfig,
                             sensor: SensorConfig, region, enable=1.0,
                             gate=None):
    """`raycast_update` of one scan into every particle's map, IN PLACE:
    particle p's scan is taken from `poses[p]` and updates the `region` =
    (Hr, Wr) window of maps[p] [P, H, W] around that pose (a region the
    size of the map is the whole map), with the cells of the full grid's
    floor minus the window's origin, as the JAX package's vmapped
    _windowed_update computes them. Every particle's entries are added in
    one index_put_(accumulate=True) into the flattened stack (a particle
    offset in the index; within a particle, in the single update's
    order); then the cells they touch are clamped (the rest of each
    window holds clamped values already). Where the bool device tensor
    `gate` is false, -0.0 is added and nothing clamped, as in
    `raycast_window`: the maps keep their bits. Returns `maps`."""
    P, H, W = maps.shape
    (r0, c0), _ = _particle_windows(maps, poses, cfg, region)
    rows, cols, w = _raycast_entries(poses, ranges, cfg, sensor, region,
                                     cfg.origin_x, cfg.origin_y, r0, c0)
    base = torch.arange(P, device=maps.device, dtype=torch.int64) * (H * W)
    idx = ((base + r0 * W + c0)[:, None]
           + rows.to(torch.int64) * W + cols.to(torch.int64)).reshape(-1)
    flat = maps.view(-1)
    add = (w * enable).to(maps.dtype).reshape(-1)
    flat.index_put_((idx,), _build.gated(gate, add, -0.0), accumulate=True)
    v = flat[idx]
    flat[idx] = _build.gated(gate, torch.clamp(v, -cfg.l_clamp, cfg.l_clamp),
                             v)
    return maps


def dense_update_particles(maps, poses, ranges, cfg: GridConfig,
                           sensor: SensorConfig, region, enable=1.0,
                           gate=None):
    """`raycast_update_dense` of one scan into every particle's map, IN
    PLACE: particle p's `region` window of maps[p] [P, H, W] around
    `poses[p]` (placed as in `raycast_update_particles`) at its float
    origin ox + f32(c0) * res, every window at once; the old cells written
    back where the bool device tensor `gate` is false (the same bits).
    Returns `maps`."""
    P = maps.shape[0]
    Hr, Wr = region
    dev = maps.device
    (r0, c0), (ox, oy) = _particle_windows(maps, poses, cfg, region)
    pidx = torch.arange(P, device=dev)[:, None, None]
    rows = (r0[:, None] + torch.arange(Hr, device=dev))[:, :, None]
    cols = (c0[:, None] + torch.arange(Wr, device=dev))[:, None, :]
    old = maps[pidx, rows, cols]
    upd = _dense_increments(
        poses[:, 0, None, None], poses[:, 1, None, None],
        poses[:, 2, None, None], ox[:, None, None], oy[:, None, None],
        region, ranges, cfg, sensor)
    out = torch.clamp(old.to(torch.float32) + upd * enable, -cfg.l_clamp,
                      cfg.l_clamp)
    maps[pidx, rows, cols] = _build.gated(gate, out.to(maps.dtype), old)
    return maps


def resolve_update_impl(
    cfg: GridConfig, sensor: SensorConfig, auto_ctx: str = "frontend"
) -> str:
    """GridConfig.update_impl with "auto" resolved as the JAX package
    resolves it on its accelerator: the pure inverse-sensor-model update
    ("pallas") for the particle filter (`auto_ctx="pf"`), the hybrid
    update ("pallas_hybrid") for the frontend, and for a field of view
    wider than pi the sampled-ray update ("sparse"; the JAX package's
    "sparse_mxu" there is the same function accumulated by a one-hot
    matmul). Every impl of the JAX package runs: "sparse", "sparse_mxu",
    "dense" and the three kernels. A kernel named explicitly with a field
    of view wider than pi raises: the kernels test an unwrapped bearing,
    so beams past pi would never fire (the JAX package runs them so; a
    quirk of the reference, ROADMAP queue 3)."""
    impl = cfg.update_impl
    if impl not in UPDATE_IMPLS:
        raise ValueError(f"unknown update_impl {impl!r}")
    wide = sensor.fov_rad > math.pi + 1e-6
    if impl == "auto":
        if wide:
            return "sparse"
        return "pallas" if auto_ctx == "pf" else "pallas_hybrid"
    if wide and impl in PALLAS_IMPLS:
        raise NotImplementedError(
            f"update_impl={impl!r} with a field of view wider than pi: the "
            "kernel's unwrapped bearing test never fires past pi (a quirk "
            "of the reference, ROADMAP queue 3); use 'auto' or 'sparse'"
        )
    return impl


def update_constants(cfg: GridConfig, sensor: SensorConfig) -> dict:
    """The grid and sensor constants the update kernels take."""
    return dict(
        resolution=cfg.resolution,
        step=sensor.fov_rad / max(sensor.n_beams - 1, 1),
        angle_min=sensor.angle_min, min_range=sensor.min_range,
        max_range=sensor.max_range, l_free=cfg.l_free, l_occ=cfg.l_occ,
        l_clamp=cfg.l_clamp,
    )


def integrate_scan(
    logodds, pose, ranges, cfg: GridConfig, sensor: SensorConfig,
    enable: float = 1.0, origin_xy=None, origin_rc=None, plain: bool = False,
    auto_ctx: str = "frontend",
):
    """Integrate one scan taken from `pose` into `logodds` (the full grid
    or a window of it) and return the updated map, a new tensor.

    `origin_rc` is the window's integer top-left cell (host ints) on the
    config grid's lattice. The sampled-ray update takes it as it is (the
    full grid's floor minus the offset); for the others, as for the JAX
    package's inverse-sensor-model updates, it is turned into the
    equivalent float origin. `origin_xy` gives that float origin
    directly; neither means the grid's own origin.

    `resolve_update_impl(cfg, sensor, auto_ctx)` picks the update: the
    hybrid one (wedge free carve + exact endpoint cells) and the exact-ray
    one (chord-length free evidence + exact endpoint cells) take float32
    maps; the ISM one (wedge free carve + the beams' arcs) float32 or
    bfloat16 maps, accumulating in float32; the sampled-ray update
    ("sparse", "sparse_mxu") and the dense inverse sensor model
    ("dense") are PyTorch, with no kernel. `plain=True` runs the kernel's
    plain version on a CUDA tensor too (for checks only).
    """
    impl = resolve_update_impl(cfg, sensor, auto_ctx)
    if impl in ("sparse", "sparse_mxu"):
        return raycast_update(logodds, pose, ranges, cfg, sensor, enable,
                              origin_xy=origin_xy, origin_rc=origin_rc)
    if origin_rc is not None:
        origin_xy = window_origin_xy(cfg, origin_rc)
    elif origin_xy is None:
        origin_xy = (cfg.origin_x, cfg.origin_y)
    if impl == "dense":
        return raycast_update_dense(logodds, pose, ranges, cfg, sensor,
                                    enable, origin_xy=origin_xy)
    consts = update_constants(cfg, sensor)
    if impl == "pallas":
        out = logodds.clone()
        update_ism(
            out[None], pose[None], ranges, region=tuple(logodds.shape),
            origin_xy=origin_xy, enable=enable, plain=plain, **consts,
        )
        return out
    if impl == "pallas_ray":
        return update_ray(
            logodds, pose, ranges, beam_angles(sensor, logodds.device),
            origin_xy=origin_xy, resolution=cfg.resolution,
            min_range=sensor.min_range, max_range=sensor.max_range,
            angle_min=sensor.angle_min, step=consts["step"],
            l_free=cfg.l_free, l_occ=cfg.l_occ, l_clamp=cfg.l_clamp,
            ray_samples=cfg.ray_samples, enable=enable, plain=plain,
        )
    return update_hybrid(
        logodds, pose, ranges, beam_angles(sensor, logodds.device),
        origin_xy=origin_xy, enable=enable, plain=plain, **consts,
    )


def integrate_scan_window(
    logodds, pose, ranges, cfg: GridConfig, sensor: SensorConfig, *,
    origin, size, gate, cell=None, origin_xy=None, plain: bool = False,
):
    """`integrate_scan` in place on the (h, w) = `size` window of the
    map `logodds` [H, W] at the int32 device origin `origin` (None: the
    map's cell (0, 0)), when the bool device tensor `gate` is true: the
    frontend step's update, with nothing read back to the host. The
    window's cells get the bits of extract_window -> integrate_scan(...,
    origin_rc) -> write_window; a gate of 0 leaves the map bit-identical.
    With `cell` in place of `origin` the map is itself the window (the
    tiled frontend's, gathered from its tile pool; `size` its shape) and
    `cell` its top-left cell on the lattice whose cell (0, 0) lies at
    the world point `origin_xy` (default cfg's origin; the tiled world's
    is its TileConfig's): the bits of integrate_scan(...,
    origin_xy=window_origin_xy(lattice, cell)).

    Every update has this form: kernel 1 `hybrid`, `ray` and `ism` read
    the window origin and the gate from device memory
    (ops/update.py:update_hybrid_window, update_ray_window, update_ism
    with origin=), the sampled-ray update adds its entries in place
    (`raycast_window`), and the dense one computes the window out of place
    and selects it with the gate (ops/update.py:window_plain). Returns
    `logodds`."""
    impl = resolve_update_impl(cfg, sensor)
    if impl in ("sparse", "sparse_mxu"):
        return raycast_window(logodds, pose, ranges, cfg, sensor,
                              origin=origin, size=size, gate=gate, cell=cell,
                              origin_xy=origin_xy)
    oxy = (cfg.origin_x, cfg.origin_y) if origin_xy is None else origin_xy
    if impl == "dense":
        return window_plain(
            logodds, lambda g, o: raycast_update_dense(
                g, pose, ranges, cfg, sensor, origin_xy=o),
            origin=origin, cell=cell, size=tuple(size), gate=gate,
            origin_xy=oxy, resolution=cfg.resolution)
    consts = update_constants(cfg, sensor)
    angles = beam_angles(sensor, logodds.device)
    if impl == "pallas":
        if origin is None and cell is None:
            origin = torch.zeros(2, dtype=torch.int32, device=logodds.device)
        update_ism(logodds[None], pose[None], ranges, region=tuple(size),
                   origin_xy=oxy, gate=gate, origin=origin, cell=cell,
                   plain=plain, **consts)
        return logodds
    if impl == "pallas_ray":
        return update_ray_window(
            logodds, pose, ranges, angles, origin=origin, size=size,
            gate=gate, origin_xy=oxy, cell=cell, resolution=cfg.resolution,
            min_range=sensor.min_range, max_range=sensor.max_range,
            angle_min=sensor.angle_min, step=consts["step"],
            l_free=cfg.l_free, l_occ=cfg.l_occ, l_clamp=cfg.l_clamp,
            ray_samples=cfg.ray_samples, plain=plain,
        )
    return update_hybrid_window(
        logodds, pose, ranges, angles, origin=origin, size=size, gate=gate,
        origin_xy=oxy, cell=cell, plain=plain, **consts,
    )


def scan_endpoints_local(ranges, sensor: SensorConfig):
    """Beam endpoints in the sensor frame, [B, 2], plus a validity mask [B].

    Only hits (min_range < r < max_range) are valid for matching/weighting.
    """
    angles = beam_angles(sensor, ranges.device)
    r = ranges.to(torch.float32)
    valid = (r > sensor.min_range) & (r < sensor.max_range) & torch.isfinite(r)
    r_clip = torch.clamp(r, 0.0, sensor.max_range)
    pts = torch.stack(
        [r_clip * torch.cos(angles), r_clip * torch.sin(angles)], dim=-1
    )
    return pts, valid
