"""Shared-anchor map update of every particle, port of
slam2d_tpu/pf/shared_update.py in its production mode.

The scan is common to all particles. With each particle's update anchored
on the map's cell lattice (its pose's cell) and its heading snapped to one
of G slots of a global theta grid, the free-space carve of the scan depends
only on the slot, so:

1. G carve images [G, win, win] are built with the ISM update kernel
   (ops/update.py, variant "ism", l_occ = 0) on one zero stack, in one
   launch: image g is the scan from (0, 0, slot_theta[g]) in a window
   frame whose center cell holds the sensor;
2. every particle adds its slot's image into its map at its anchor cell
   and its occupancy marks at its EXACT endpoint cells, inside the window
   clamped into the map (kernel: ops/apply.py), in place.

The particles' poses and weights stay exact: only the free carve
quantizes (to the anchor cell and the slot heading). The production mode
is exact fused endpoints, update_subcell 1, no bilinear placement, no
dither and no carve shrink; the other settings are the JAX package's
diagnostics and raise NotImplementedError here, as do the quantized_*
update modes.
"""

from __future__ import annotations

import numpy as np
import torch

from slam2d_tpu_torch.config import FrontendConfig, PFConfig
from slam2d_tpu_torch.core import se2
from slam2d_tpu_torch.core.numerics import inv_f32
from slam2d_tpu_torch.grid.occupancy import (
    beam_angles,
    update_constants,
    world_to_cell,
)
from slam2d_tpu_torch.grid.window import update_window_cells
from slam2d_tpu_torch.ops.apply import shared_apply
from slam2d_tpu_torch.ops.update import update_ism

# image stacks above this many float32 bytes are stored as bf16
IMAGE_F32_BYTES = 4 * 2**20


def check_production_mode(pf: PFConfig) -> None:
    """Raise NotImplementedError naming the first shared-update setting
    outside the production mode the port implements."""
    knobs = (
        ("update_exact_endpoints", True), ("update_fused_endpoints", True),
        ("update_carve_shrink", 0.0), ("update_subcell", 1),
        ("update_bilinear", False), ("update_anchor_dither", "off"),
    )
    for name, want in knobs:
        if getattr(pf, name) != want:
            raise NotImplementedError(
                f"shared update with {name}={getattr(pf, name)!r}: only the "
                f"production mode ({name}={want!r}) is ported; the other "
                "settings are the JAX package's diagnostics"
            )


def slot_grid(poses, cfg: FrontendConfig, pf: PFConfig):
    """(slot [P] int64, slot_theta [G] float32): each particle's slot on
    the global theta grid centered on the poses' circular mean heading,
    and the grid's headings. The slot step keeps the farthest endpoint
    within update_qstep_cells cells, widened when the headings spread
    past the grid's coverage."""
    res = cfg.grid.resolution
    G = pf.update_theta_slots
    P = poses.shape[0]
    theta = poses[:, 2]
    # a mean as XLA compiles it: the sum times float32(1 / P)
    inv_p = inv_f32(P)
    mean_t = torch.atan2(
        torch.sin(theta).sum() * inv_p, torch.cos(theta).sum() * inv_p
    )
    dth = se2.wrap_angle(theta - mean_t)
    qstep = 2.0 * pf.update_qstep_cells * res / max(cfg.sensor.max_range, res)
    step = torch.maximum(
        torch.tensor(np.float32(qstep), device=poses.device),
        2.0 * dth.abs().max() * inv_f32(max(G - 1, 1)),
    )
    slot = torch.clamp(
        torch.round(dth / step).to(torch.int64) + G // 2, 0, G - 1
    )
    k = torch.arange(G, dtype=torch.float32, device=poses.device) - G // 2
    return slot, mean_t + k * step


def carve_operands(slot_theta, cfg: FrontendConfig, win: int):
    """(poses [G, 3], origin_xy, constants) of the ISM update that builds
    the carve images: the sensor at world (0, 0) with one heading a slot,
    in a frame whose origin puts it at the center of cell (win // 2,
    win // 2), l_occ = 0."""
    res = cfg.grid.resolution
    o = float(np.float32(-(win // 2) * res - 0.5 * res))
    poses = torch.zeros(
        (slot_theta.shape[0], 3), dtype=torch.float32,
        device=slot_theta.device,
    )
    poses[:, 2] = slot_theta
    consts = update_constants(cfg.grid, cfg.sensor)
    consts["l_occ"] = 0.0
    return poses, (o, o), consts


def carve_images(ranges, slot_theta, cfg: FrontendConfig, win: int,
                 plain: bool = False):
    """[G, win, win] float32 free-carve images of the scan, one per slot
    heading, from one launch of the ISM update on a zero stack, with the
    operands of carve_operands."""
    poses, origin_xy, consts = carve_operands(slot_theta, cfg, win)
    images = torch.zeros(
        (slot_theta.shape[0], win, win), dtype=torch.float32,
        device=ranges.device,
    )
    return update_ism(
        images, poses, ranges, region=(win, win), origin_xy=origin_xy,
        plain=plain, **consts,
    )


def endpoint_operands(poses, anchors, ranges, cfg: FrontendConfig, win: int,
                      H: int, W: int):
    """(rows, cols [P, B] int32, weights [P, B] float32): each particle's
    exact endpoint cell of every beam, clipped onto the map, and l_occ for
    the hitting beams whose cell lies inside the win x win window clamped
    into the map around the anchor (grid/window.py:window_origin), else 0
    (pf/shared_update.py:_endpoint_operands)."""
    g, s = cfg.grid, cfg.sensor
    r = ranges.to(torch.float32)
    valid = (r > s.min_range) & torch.isfinite(r)
    hit = valid & (r < s.max_range)
    r_clip = torch.clamp(r, 0.0, s.max_range)
    angles = beam_angles(s, ranges.device)[None, :] + poses[:, 2:3]   # [P, B]
    inv_res = inv_f32(g.resolution)   # XLA's form of the division by res
    ex = poses[:, 0:1] + torch.cos(angles) * r_clip
    ey = poses[:, 1:2] + torch.sin(angles) * r_clip
    ecol = torch.floor((ex - g.origin_x) * inv_res).to(torch.int32)
    erow = torch.floor((ey - g.origin_y) * inv_res).to(torch.int32)
    r0 = torch.clamp(anchors[:, 0:1] - win // 2, 0, H - win)
    c0 = torch.clamp(anchors[:, 1:2] - win // 2, 0, W - win)
    inside = (
        (erow >= r0) & (erow < r0 + win) & (ecol >= c0) & (ecol < c0 + win)
    )
    w = torch.where(hit[None, :] & inside, float(g.l_occ), 0.0)
    return (
        torch.clamp(erow, 0, H - 1).contiguous(),
        torch.clamp(ecol, 0, W - 1).contiguous(),
        w.contiguous(),
    )


def apply_operands(poses, ranges, cfg: FrontendConfig, pf: PFConfig, H: int,
                   W: int, plain: bool = False):
    """The operands of the apply kernel for maps of H x W: (anchors [P, 2]
    int32, slots [P] int32, images [G, win, win] (float32, or bfloat16
    past IMAGE_F32_BYTES unless pf.update_images_f32), (rows, cols,
    weights) of the endpoint marks)."""
    win = min(update_window_cells(cfg.grid, cfg.sensor), H, W)
    slot, slot_theta = slot_grid(poses, cfg, pf)
    images = carve_images(ranges, slot_theta, cfg, win, plain=plain)
    if images.numel() * 4 > IMAGE_F32_BYTES and not pf.update_images_f32:
        images = images.to(torch.bfloat16)
    anchors = world_to_cell(poses[:, :2], cfg.grid).contiguous()     # [P, 2]
    ep = endpoint_operands(poses, anchors, ranges, cfg, win, H, W)
    return anchors, slot.to(torch.int32), images, ep


def shared_update(logodds, poses, ranges, cfg: FrontendConfig, pf: PFConfig,
                  plain: bool = False):
    """Update every particle's map with one scan, IN PLACE (module
    docstring); returns `logodds` [P, H, W] (float32 or bfloat16).

    `poses` [P, 3] and `ranges` [B] float32 on the maps' device. Nothing
    is read back to the host. `plain=True` runs every kernel's plain
    version (checks only)."""
    check_production_mode(pf)
    H, W = logodds.shape[1:]
    anchors, slots, images, ep = apply_operands(
        poses, ranges, cfg, pf, H, W, plain=plain
    )
    return shared_apply(
        logodds, anchors, slots, images, float(cfg.grid.l_clamp), *ep,
        plain=plain,
    )
