"""PyTorch port: the exact-ray map update (ops/update.py:update_ray,
kernel 1 variant "ray") against the JAX package's
pallas_dense_update(variant="ray") in interpret mode (CPU), and the
frontend with update_impl="pallas_ray" against the JAX frontend.

Tolerances:
- With the same beam tables (built here with JAX's operations, as the TPU
  kernel's wrapper builds them), both channels are bit-exact: the port
  computes the cell center ox + (col + 0.5) * res, t = cx*dx + cy*dy, ct
  and each chunk's sum with the fused multiply-adds XLA contracts them
  into on the CPU (before, with the products rounded apart, the free
  channel was 9.4e-5 off, the chord's cross-track ramp, of slope
  1 / (|dx| |dy|), amplifying an ulp of ct for a beam near an axis).
- With the port's own tables, XLA's cos/sin (not correctly rounded; they
  differ from torch's in the last bit for ~5% of angles) and its fused
  pose + dir * r move an endpoint on a cell edge into the neighbouring
  cell: at most 0.02% of cells may then differ by one l_occ, and the free
  channel stays within 2e-3.
- The frontend run: per-scan poses within 5e-3 m / rad and ATE within
  5 mm of the JAX frontend's.
- The kernel's per-tile beam clip (`ray_chunk_bounds`, and the clipped
  mode of `update_ray_plain` that sums only each tile's chunks): bit-exact
  to the full sum, and the bounds hold every beam that touches a tile.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam2d_tpu.config import GridConfig
from slam2d_tpu_torch.config import SensorConfig as PortSensor
from slam2d_tpu.metrics import ate_rmse
from slam2d_tpu.ops.pallas_update import pallas_dense_update
from slam2d_tpu.run import frontend as jfe
from slam2d_tpu_torch.grid import occupancy as tocc
from slam2d_tpu_torch.ops import update as tupd
from slam2d_tpu_torch.run import frontend as tfe
from torch_parity import (
    SENSOR,
    e2e_log,
    frontend_cfg,
    pose_error,
    synth_ranges,
    to_port,
)

torch.set_num_threads(1)

# tests/test_pallas_ray.py's grid and pose
GCFG = GridConfig(
    height=256, width=256, resolution=0.1, center_x=10.0, center_y=10.0,
    ray_samples=128, update_impl="pallas_ray",
)
POSE = np.array([6.3, 5.8, 0.4], np.float32)


@jax.jit
def _jax_tables(pose, ranges, ox, oy):
    """The TPU kernel's wrapper's beam tables (pallas_update.py:321-370),
    padded to 8 beams as there."""
    res, ms = GCFG.resolution, SENSOR.max_range
    r = jnp.clip(ranges, 0.0, ms)
    valid = (ranges > SENSOR.min_range) & jnp.isfinite(ranges)
    hit = valid & (ranges < ms)
    angles = jnp.asarray(np.asarray(SENSOR.beam_angles()), jnp.float32) + pose[2]
    dirx, diry = jnp.cos(angles), jnp.sin(angles)
    r_free = jnp.maximum(r - res, 0.0) * valid
    w_free = valid / jnp.maximum(r_free / GCFG.ray_samples, res)
    adx, ady = jnp.abs(dirx), jnp.abs(diry)
    amax, amin = jnp.maximum(adx, ady), jnp.minimum(adx, ady)
    ecol = jnp.floor((pose[0] + dirx * r - ox) / res)
    erow = jnp.floor((pose[1] + diry * r - oy) / res)
    rays = jnp.stack([
        dirx, diry, w_free, res / jnp.maximum(amax, 1e-6),
        0.5 * res * (adx + ady), 1.0 / jnp.maximum(amax * amin, 1e-9),
        r_free, jnp.where(hit, erow, -1e9), jnp.where(hit, ecol, -1e9),
    ])
    pad = (-rays.shape[1]) % 8
    fill = jnp.zeros((9, pad), jnp.float32).at[7:].set(-1e9)
    return jnp.concatenate([rays, fill], axis=1)


def _case(origin_rc, l_free, l_occ, seed=1):
    gcfg = dataclasses.replace(GCFG, l_free=l_free, l_occ=l_occ)
    size = 256 if origin_rc is None else 160
    grid = np.random.default_rng(seed).uniform(-5, 5, (size, size)).astype(
        np.float32
    )
    ranges = synth_ranges(POSE)
    ranges[5::17] = np.inf                      # invalid beams
    ranges[9::23] = np.float32(SENSOR.max_range)  # no hit
    kw = {}
    ox, oy = gcfg.origin_x, gcfg.origin_y
    if origin_rc is not None:
        ox, oy = tocc.window_origin_xy(to_port(gcfg), origin_rc)
        kw = dict(origin_xy=(ox, oy))
    ref = np.asarray(pallas_dense_update(
        jnp.asarray(grid), jnp.asarray(POSE), jnp.asarray(ranges), gcfg,
        SENSOR, interpret=True, variant="ray", **kw,
    ))
    return gcfg, grid, ranges, (ox, oy), ref


@pytest.mark.parametrize("origin_rc", [None, (40, 72)])
@pytest.mark.parametrize("channel", ["occupied", "free", "both"])
def test_ray_plain_matches_pallas_with_its_tables(origin_rc, channel):
    l_free, l_occ = {"occupied": (0.0, 0.85), "free": (-0.4, 0.0),
                     "both": (-0.4, 0.85)}[channel]
    gcfg, grid, ranges, (ox, oy), ref = _case(origin_rc, l_free, l_occ)
    rays = np.array(_jax_tables(
        jnp.asarray(POSE), jnp.asarray(ranges), jnp.float32(ox),
        jnp.float32(oy),
    ))
    out = tupd.update_ray_plain(
        torch.from_numpy(grid), torch.from_numpy(POSE), torch.from_numpy(rays),
        origin_xy=(ox, oy), resolution=gcfg.resolution, l_free=l_free,
        l_occ=l_occ, l_clamp=gcfg.l_clamp,
    ).numpy()
    assert (out != grid).sum() > 100
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("origin_rc", [None, (40, 72)])
def test_ray_update_matches_pallas(origin_rc):
    """integrate_scan with update_impl="pallas_ray", tables and all."""
    for l_free, l_occ in ((0.0, 0.85), (-0.4, 0.0)):
        gcfg, grid, ranges, _, ref = _case(origin_rc, l_free, l_occ)
        out = tocc.integrate_scan(
            torch.from_numpy(grid), torch.from_numpy(POSE),
            torch.from_numpy(ranges), to_port(gcfg), to_port(SENSOR),
            origin_rc=origin_rc,
        ).numpy()
        diff = np.abs(out - ref)
        if l_free == 0.0:
            off = diff[diff != 0]
            assert off.size <= 0.0002 * diff.size
            np.testing.assert_allclose(off, gcfg.l_occ, rtol=0, atol=1e-5)
        else:
            assert diff.max() <= 2e-3
        assert (out != grid).sum() > 100


def test_ray_tables_pad_to_the_chunk():
    rays = tupd.ray_tables(
        torch.from_numpy(POSE), torch.ones(13),
        torch.linspace(-1.5, 1.5, 13), origin_xy=(0.0, 0.0), resolution=0.1,
        min_range=0.1, max_range=12.0, ray_samples=128,
    )
    assert rays.shape == (9, 16) and rays.dtype == torch.float32
    assert (rays[:7, 13:] == 0).all() and (rays[7:, 13:] == -1e9).all()


@pytest.mark.parametrize("bad", ["grid_dtype", "beams", "device"])
def test_ray_wrapper_rejects_bad_input(bad):
    grid, ranges = torch.zeros(32, 32), torch.ones(180)
    angles = torch.linspace(-1.5, 1.5, 180)
    pose = torch.from_numpy(POSE)
    if bad == "grid_dtype":
        grid = grid.double()
    elif bad == "beams":
        ranges, angles = torch.ones(1400), torch.zeros(1400)
    else:
        grid, ranges, angles, pose = (
            t.to("meta") for t in (grid, ranges, angles, pose)
        )
    with pytest.raises(ValueError):
        tupd.update_ray(
            grid, pose, ranges, angles, origin_xy=(0.0, 0.0), resolution=0.1,
            min_range=0.1, max_range=12.0, angle_min=-1.5, step=3.0 / 179,
            l_free=-0.4, l_occ=0.85, l_clamp=10.0, ray_samples=128,
        )


def test_frontend_with_ray_update_matches_jax():
    cfg = frontend_cfg(512, update_impl="pallas_ray")
    log = {k: v[:80] for k, v in e2e_log().items()}   # 5 chunks of 16
    _, jt, jsc = jfe.run_frontend(log, cfg)
    _, tt, tsc = tfe.run_frontend(log, to_port(cfg), torch.device("cpu"))
    dxy, dth = pose_error(tt, jt)
    gt = log["gt_poses"]
    ate_t = ate_rmse(tt, gt, align=False)
    ate_j = ate_rmse(jt, gt, align=False)
    ate_odom = ate_rmse(log["odom"], gt, align=False)
    print(f"max |dxy| {dxy:.3g} m, |dtheta| {dth:.3g} rad; ATE port "
          f"{ate_t:.4f} JAX {ate_j:.4f} odometry {ate_odom:.4f}")
    assert np.isfinite(tt).all()
    assert dxy <= 5e-3 and dth <= 5e-3
    np.testing.assert_array_equal(tsc == -1.0, jsc == -1.0)
    assert abs(ate_t - ate_j) <= 0.005


# ---- the kernel's per-tile beam clip ---------------------------------------

def _bounds(pose, ranges, shape, sensor, res, origin_xy):
    return tupd.ray_chunk_bounds(
        pose, ranges, shape, origin_xy=origin_xy, resolution=res,
        min_range=sensor.min_range, max_range=sensor.max_range,
        angle_min=sensor.angle_min,
        step=sensor.fov_rad / max(sensor.n_beams - 1, 1),
    )


def _plain(grid, pose, ranges, sensor, res, origin_xy, bounds):
    angles = torch.from_numpy(np.asarray(sensor.beam_angles(), np.float32))
    rays = tupd.ray_tables(
        pose, ranges, angles, origin_xy=origin_xy, resolution=res,
        min_range=sensor.min_range, max_range=sensor.max_range,
        ray_samples=128,
    )
    return tupd.update_ray_plain(
        grid, pose, rays, origin_xy=origin_xy, resolution=res, l_free=-0.4,
        l_occ=0.85, l_clamp=10.0, bounds=bounds,
    )


@pytest.mark.parametrize("case", ["256", "windowed_520"])
def test_ray_clip_matches_full_sum(case):
    """Summing only each tile's chunks gives the full sum's bits, on
    GCFG's 256^2 grid and on a 520^2 window of a 1024^2 grid at 0.05 m
    (bench.py's update window), the scan of the box-rooms world."""
    sensor = to_port(SENSOR)
    if case == "256":
        size, res, pose = 256, GCFG.resolution, POSE
        origin_xy = (GCFG.origin_x, GCFG.origin_y)
    else:
        g = to_port(dataclasses.replace(
            GCFG, height=1024, width=1024, resolution=0.05,
        ))
        size, res = 520, g.resolution
        pose = np.array([9.1, 4.3, 2.2], np.float32)
        center = tocc.world_to_cell(torch.from_numpy(pose[:2]), g).tolist()
        origin_xy = tocc.window_origin_xy(
            g, (center[0] - size // 2, center[1] - size // 2)
        )
    grid = torch.from_numpy(np.random.default_rng(3).uniform(
        -5, 5, (size, size)).astype(np.float32))
    ranges = synth_ranges(pose)
    ranges[5::17] = np.inf
    ranges[9::23] = np.float32(SENSOR.max_range)
    pose_t, ranges_t = torch.from_numpy(pose), torch.from_numpy(ranges)
    bounds = _bounds(pose_t, ranges_t, (size, size), sensor, res, origin_xy)
    full = _plain(grid, pose_t, ranges_t, sensor, res, origin_xy, None)
    clipped = _plain(grid, pose_t, ranges_t, sensor, res, origin_xy, bounds)
    assert (full != grid).sum() > 1000
    np.testing.assert_array_equal(clipped.numpy(), full.numpy())
    trips = (bounds[..., 1] - bounds[..., 0]).sum().item()
    assert trips < 0.5 * bounds[..., 0].numel() * (-(-sensor.n_beams // 8))


CLIP_SENSORS = {
    # half the plane behind the sensor; the seam of the bearings at beam 0
    "fov180": PortSensor(n_beams=180, max_range=5.0),
    # a whole turn: beams at both ends of the table look the same way
    "fov360": PortSensor(n_beams=240, fov_rad=2 * np.pi * 239 / 240,
                         max_range=5.0, angle_min=-np.pi),
}


def _touching_pairs(sensor, seed, H=160, W=160, res=0.1):
    """A seeded pose and scan of at most 5 m over an H x W grid at `res`
    from (0, 0), the scan's tables, and every (beam, row, col) whose chord
    term is nonzero or whose endpoint marks the cell: (pose, ranges, rays,
    (b, r, c))."""
    rng = np.random.default_rng(100 + seed)
    origin_xy = (0.0, 0.0)
    pose = np.array([*rng.uniform(5.0, 11.0, 2), rng.uniform(-np.pi, np.pi)],
                    np.float32)
    B = sensor.n_beams
    ranges = rng.uniform(0.3, 4.9, B).astype(np.float32)
    ranges[3::29] = np.inf                         # invalid
    ranges[7::31] = np.float32(sensor.max_range)   # no hit
    ranges[11::37] = np.float32(0.05)              # below min_range
    pose_t, ranges_t = torch.from_numpy(pose), torch.from_numpy(ranges)

    # every beam's own terms over the grid: [Bpad, H, W]
    angles = torch.from_numpy(np.asarray(sensor.beam_angles(), np.float32))
    rays = tupd.ray_tables(
        pose_t, ranges_t, angles, origin_xy=origin_xy, resolution=res,
        min_range=sensor.min_range, max_range=sensor.max_range,
        ray_samples=128,
    )
    dx, dy, w, cm, hf, ia, rf, er, ec = (t[:, None, None] for t in rays)
    col = torch.arange(W, dtype=torch.float32)
    row = torch.arange(H, dtype=torch.float32)
    cx = (origin_xy[0] + (col + 0.5) * res - pose_t[0])[None, None, :]
    cy = (origin_xy[1] + (row + 0.5) * res - pose_t[1])[None, :, None]
    t = cx * dx + cy * dy
    ct = torch.abs(cx * dy - cy * dx)
    L = torch.clamp_min(torch.minimum(cm, (hf - ct) * ia), 0.0)
    f = w * torch.clamp_min(
        torch.minimum(t + 0.5 * L, rf) - torch.clamp_min(t - 0.5 * L, 0.0), 0.0
    )
    o = (row[None, :, None] == er) & (col[None, None, :] == ec)
    b, r, c = np.nonzero(((f != 0) | o).numpy())
    assert b.size > 1000 and o.sum() > 50
    return pose_t, ranges_t, rays, (b, r, c)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("sensor_name", sorted(CLIP_SENSORS))
def test_ray_chunk_bounds_hold_every_touching_beam(sensor_name, seed):
    """Every (beam, cell) pair with a nonzero chord term or an endpoint
    mark lies in a chunk of its tile's bounds, on a 160^2 grid at 0.1 m
    (the kernel's tiles) from seeded poses and scans of at most 5 m. The cases
    include the tile holding the sensor (every chunk), tiles beyond the
    scan's range and, at 180 degrees, tiles behind the sensor (no chunk),
    and tiles across the seam of the bearings at beam 0 (at 360 degrees
    they take chunks of both ends, so every chunk)."""
    sensor = CLIP_SENSORS[sensor_name]
    H = W = 160
    res, origin_xy = 0.1, (0.0, 0.0)
    pose_t, ranges_t, rays, (b, r, c) = _touching_pairs(sensor, seed)
    pose, ranges = pose_t.numpy(), ranges_t.numpy()
    B = sensor.n_beams
    bounds = _bounds(pose_t, ranges_t, (H, W), sensor, res, origin_xy).numpy()
    n_chunks = -(-B // 8)
    ty, tx = tupd._RAY_TILE
    lo, hi = bounds[r // ty, c // tx, 0], bounds[r // ty, c // tx, 1]
    chunk = b // 8
    bad = (chunk < lo) | (chunk >= hi)
    assert not bad.any(), (
        f"{bad.sum()} touching (beam, cell) pairs outside their tile's "
        f"chunks, e.g. beam {b[bad][0]} cell {r[bad][0], c[bad][0]}"
    )

    # the cases this draw covers
    iy, ix = np.meshgrid(np.arange(bounds.shape[0]),
                         np.arange(bounds.shape[1]), indexing="ij")
    corners = [(iy * ty + i, ix * tx + j)
               for i in (0, ty - 1) for j in (0, tx - 1)]
    pc = (pose[:2] - np.array(origin_xy)) / res - 0.5     # in cell indices
    rel = [np.mod(np.arctan2(rr - pc[1], cc - pc[0]) - pose[2]
                  - sensor.angle_min, 2 * np.pi) for rr, cc in corners]
    rel = np.stack(rel)                                  # [4, tiles]
    gap_y = np.maximum(0, np.maximum(iy * ty - pc[1], pc[1] - iy * ty - ty + 1))
    gap_x = np.maximum(0, np.maximum(ix * tx - pc[0], pc[0] - ix * tx - tx + 1))
    dist = np.hypot(gap_y, gap_x) * res
    rmax = ranges[(ranges > sensor.min_range) & np.isfinite(ranges)].max()
    lo, hi = bounds[..., 0], bounds[..., 1]
    sensor_tile = (int(pc[1] + 0.5) // ty, int(pc[0] + 0.5) // tx)
    assert tuple(bounds[sensor_tile]) == (0, n_chunks)
    beyond = dist > rmax + 0.1
    assert beyond.any() and (hi[beyond] == lo[beyond]).all()
    inside = (dist > 0.3) & (dist < rmax - 0.1)
    seam = inside & (rel.max(0) - rel.min(0) > np.pi)
    assert seam.any() and (lo[seam] == 0).all()
    if sensor_name == "fov360":
        assert (hi[seam] == n_chunks).all()
    else:
        behind = inside & (rel.min(0) > np.pi + 0.3) & (
            rel.max(0) < 2 * np.pi - 0.3
        )
        assert behind.any() and (hi[behind] == lo[behind]).all()


# ---- the particle form's strips and its skip-zero chain --------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("sensor_name", sorted(CLIP_SENSORS))
def test_ray_strip_beams_hold_every_touching_beam(sensor_name, seed):
    """Kernel 1 `ray`'s particle form narrows each thread's beams below the
    8-beam chunk, a strip of 4 cells at a time (`ray_strip_beams`): every
    (beam, cell) pair with a nonzero chord term or an endpoint mark lies
    in its strip's beams, with the strips `seed` cells off the window's
    first column (the window's column mod 4 in its map), on tests/
    test_ray_chunk_bounds_hold_every_touching_beam's draws: the strips at
    the sensor (every beam), beyond the scan's reach and behind a
    180-degree sensor (none), across the seam of the bearings at beam 0.
    The strip sum has the full sum's bits, and the strips keep a third of
    the tiles' (cell, beam) pairs or fewer."""
    sensor = CLIP_SENSORS[sensor_name]
    H = W = 160
    res, origin_xy = 0.1, (0.0, 0.0)
    pose_t, ranges_t, rays, (b, r, c) = _touching_pairs(sensor, seed)
    step = sensor.fov_rad / max(sensor.n_beams - 1, 1)
    keep = tupd.ray_strip_beams(
        pose_t, ranges_t, rays, (H, W), origin_xy=origin_xy, resolution=res,
        min_range=sensor.min_range, max_range=sensor.max_range,
        angle_min=sensor.angle_min, step=step, col_offset=seed).numpy()
    bad = ~keep[r, (c + seed) // 4, b]
    assert not bad.any(), (
        f"{bad.sum()} touching (beam, cell) pairs outside their strip's "
        f"beams, e.g. beam {b[bad][0]} cell {r[bad][0], c[bad][0]}")
    n_beams = keep.sum(-1)
    assert (n_beams == sensor.n_beams).any()     # the strips at the sensor
    assert (n_beams == 0).any()                  # beyond reach, behind
    bounds = _bounds(pose_t, ranges_t, (H, W), sensor, res, origin_xy)
    tiled = 8 * (bounds[..., 1] - bounds[..., 0]).sum().item() * 128
    assert 4 * keep.sum() < tiled / 3

    grid = torch.from_numpy(np.random.default_rng(seed).uniform(
        -5, 5, (H, W)).astype(np.float32))
    kw = dict(origin_xy=origin_xy, resolution=res, l_free=-0.4, l_occ=0.85,
              l_clamp=10.0)
    full = tupd.update_ray_plain(grid, pose_t, rays, **kw)
    strip = tupd.update_ray_plain(grid, pose_t, rays, beams=torch.from_numpy(
        keep), col_offset=seed, **kw)
    np.testing.assert_array_equal(strip.numpy(), full.numpy())


CHAIN_CASES = {
    # which of a chunk's 8 terms are nonzero (beyond these: a random third)
    "beams_0_and_1": (True, True),
    "beam_0_alone": (True, False),
    "beam_1_first": (False, True),
    "from_beam_2": (False, False),
}


@pytest.mark.parametrize("case", sorted(CHAIN_CASES) + ["none", "random"])
def test_ray_chunk_sum_skipping_zero_terms_keeps_its_bits(case):
    """A chunk's sum over only its kept beams (`ray_chunk_sum` with keep,
    the particle form's chain: the first kept term rounded once, fma for
    each later one, fma(w0, c0, w1 c1) where beams 0 and 1 are both kept)
    has the bits of the full chain, fma(w0, c0, w1 c1) then fma(wk, ck,
    sum), wherever every skipped term is zero; kept zeros change nothing
    either. Added to a running sum, a chunk with no kept beam adds
    nothing."""
    rng = np.random.default_rng(sorted(CHAIN_CASES).index(case)
                                if case in CHAIN_CASES else 7)
    n = 4096
    w = torch.from_numpy(rng.uniform(0.05, 20.0, (8, 1)).astype(np.float32))
    chord = rng.uniform(0.0, 0.08, (8, n)).astype(np.float32)
    nonzero = rng.random((8, n)) < 1 / 3
    if case in CHAIN_CASES:
        nonzero[:2] = np.array(CHAIN_CASES[case])[:, None]
    elif case == "none":
        nonzero[:] = False
    chord = torch.from_numpy(np.where(nonzero, chord, np.float32(0)))
    keep = torch.from_numpy(nonzero | (rng.random((8, n)) < 0.2))
    full = tupd.ray_chunk_sum(w, chord)
    kept = tupd.ray_chunk_sum(w, chord, keep)
    some = keep.any(0)
    assert torch.equal(kept[some], full[some])
    for base in (0.0, 0.3, -1.7, 123.4):
        assert torch.equal(base + kept, base + full)
