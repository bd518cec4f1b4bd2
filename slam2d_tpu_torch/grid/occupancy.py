"""Log-odds occupancy grid as a fixed-shape [H, W] tensor.

Port of slam2d_tpu/grid/occupancy.py for the frontend and the particle
filter: rows = y, cols = x, world-anchored at GridConfig.origin. Scan
integration runs the updates of ops/update.py: the two that the JAX
package resolves "auto" to on its accelerator (the hybrid update for the
frontend, the pure ISM update for the particle filter) and the exact-ray
update ("pallas_ray").
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from slam2d_tpu_torch.config import GridConfig, SensorConfig
from slam2d_tpu_torch.core.numerics import inv_f32
from slam2d_tpu_torch.ops.update import (
    update_hybrid,
    update_hybrid_window,
    update_ism,
    update_ray,
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


def resolve_update_impl(
    cfg: GridConfig, sensor: SensorConfig, auto_ctx: str = "frontend"
) -> str:
    """GridConfig.update_impl with "auto" resolved as the JAX package
    resolves it on its accelerator: the pure inverse-sensor-model update
    ("pallas") for the particle filter (`auto_ctx="pf"`), the hybrid
    update ("pallas_hybrid") for the frontend. These two and the
    exact-ray update ("pallas_ray") are ported; every other impl (the
    sampled-ray and XLA updates), and a field of view wider than pi
    (which the kernels' unwrapped bearing test cannot cover), raises."""
    impl = cfg.update_impl
    if impl == "auto":
        impl = "pallas" if auto_ctx == "pf" else "pallas_hybrid"
    if impl not in ("pallas", "pallas_hybrid", "pallas_ray"):
        raise NotImplementedError(
            f"update_impl={cfg.update_impl!r}: only the dense updates "
            "('auto', 'pallas', 'pallas_hybrid', 'pallas_ray') are ported"
        )
    if sensor.fov_rad > math.pi + 1e-6:
        raise NotImplementedError(
            "field of view wider than pi needs the sparse update, which is "
            "not ported"
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
    config grid's lattice; like the JAX package's inverse-sensor-model
    kernels it is turned into the equivalent float origin. `origin_xy`
    gives that float origin directly; neither means the grid's own origin.

    `resolve_update_impl(cfg, sensor, auto_ctx)` picks the update: the
    hybrid one (wedge free carve + exact endpoint cells) and the exact-ray
    one (chord-length free evidence + exact endpoint cells) take float32
    maps; the ISM one (wedge free carve + the beams' arcs) float32 or
    bfloat16 maps, accumulating in float32. `plain=True` runs the kernel's
    plain version on a CUDA tensor too (for checks only).
    """
    impl = resolve_update_impl(cfg, sensor, auto_ctx)
    if origin_rc is not None:
        origin_xy = window_origin_xy(cfg, origin_rc)
    elif origin_xy is None:
        origin_xy = (cfg.origin_x, cfg.origin_y)
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
    origin, size, gate, plain: bool = False,
):
    """`integrate_scan` in place on the (h, w) = `size` window of the
    map `logodds` [H, W] at the int32 device origin `origin` (None: the
    map's cell (0, 0)), when the bool device tensor `gate` is true: the
    frontend step's update, with nothing read back to the host. The
    window's cells get the bits of extract_window -> integrate_scan(...,
    origin_rc) -> write_window; a gate of 0 leaves the map bit-identical.
    Only the hybrid update (update_impl "pallas_hybrid", the frontend's
    "auto") has this form (kernel 1 `hybrid`, ops/update.py:
    update_hybrid_window). Returns `logodds`."""
    impl = resolve_update_impl(cfg, sensor)
    if impl != "pallas_hybrid":
        raise NotImplementedError(
            f"update_impl {impl!r} has no in-place gated form; only the "
            "hybrid update does"
        )
    return update_hybrid_window(
        logodds, pose, ranges, beam_angles(sensor, logodds.device),
        origin=origin, size=size, gate=gate,
        origin_xy=(cfg.origin_x, cfg.origin_y), plain=plain,
        **update_constants(cfg, sensor),
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
