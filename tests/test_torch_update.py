"""PyTorch port: the hybrid map update and the occupancy helpers against
the JAX package (CPU; the TPU kernel runs in interpret mode).

The port's kernel 1 computes a cell's bearing as the TPU kernel does
under XLA (its polynomial atan2, `core/numerics.py:atan2_ref`, and the
cell centre as one FMA) in its `hybrid` and `ism` forms, and the `ray`
form's chord with XLA's FMAs; the hybrid update takes its endpoints from
the framework's cos/sin, where the TPU kernel uses XLA's cos/sin. A
last-bit difference there moves an endpoint across a cell edge, so the
hybrid contract is: at least 99.95% of cells bit-identical, and every
other cell off by exactly one l_free or one l_occ. On windows of full
SLAM's seed-4 log and of FastSLAM-100's log where torch.atan2 would move
a cell across a beam slot's edge, the `hybrid` and `ism` updates are the
reference's exactly, and at the latter the `ray` update on the
reference's beam tables too.
"""

import dataclasses
import math

import chip_smoke
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam2d_tpu.config import GridConfig, SensorConfig
from slam2d_tpu.grid import occupancy as jocc
from slam2d_tpu.ops.pallas_update import pallas_dense_update
from slam2d_tpu_torch.grid import occupancy as tocc
from slam2d_tpu_torch.ops import update as tupd
from slam2d_tpu_torch.run import bench_configs as bc
from torch_parity import SENSOR, synth_ranges, to_port

torch.set_num_threads(1)

GCFG = GridConfig(
    height=256, width=256, resolution=0.1, center_x=10.0, center_y=10.0,
    update_impl="pallas_hybrid",
)
POSE = np.array([6.3, 5.8, 0.4], np.float32)


def _ranges(case: str) -> np.ndarray:
    r = synth_ranges(POSE)
    if case == "short":
        r = r * np.float32(0.3)
    elif case == "all_invalid":
        r = np.full_like(r, 0.05)
    elif case == "nan":
        r = r.copy()
        r[::7] = np.nan
        r[3::11] = np.inf
    return r


def _assert_update_parity(ref: np.ndarray, out: np.ndarray, cfg: GridConfig):
    assert out.shape == ref.shape and out.dtype == np.float32
    diff = np.abs(out - ref)
    n_diff = int((diff != 0).sum())
    print(f"cells differing: {n_diff} of {ref.size}")
    assert n_diff <= 0.0005 * ref.size
    off = diff[diff != 0]
    one_step = np.isclose(off, abs(cfg.l_free), atol=1e-5) | np.isclose(
        off, cfg.l_occ, atol=1e-5
    )
    assert one_step.all(), off[~one_step]


@pytest.mark.parametrize(
    "case,enable",
    [("scan", 1.0), ("short", 1.0), ("all_invalid", 1.0), ("nan", 1.0),
     ("scan", 0.0)],
)
def test_update_matches_pallas_hybrid(case, enable):
    grid = np.random.default_rng(1).uniform(-5, 5, (256, 256)).astype(
        np.float32
    )
    ranges = _ranges(case)
    ref = np.asarray(
        pallas_dense_update(
            jnp.asarray(grid), jnp.asarray(POSE), jnp.asarray(ranges), GCFG,
            SENSOR, enable=enable, interpret=True, variant="hybrid",
        )
    )
    out = tocc.integrate_scan(
        torch.from_numpy(grid), torch.from_numpy(POSE),
        torch.from_numpy(ranges), to_port(GCFG), to_port(SENSOR),
        enable=enable,
    ).numpy()
    _assert_update_parity(ref, out, GCFG)
    if case == "all_invalid" or enable == 0.0:
        np.testing.assert_array_equal(out, grid)
    else:
        assert (out != grid).sum() > 500


@pytest.mark.parametrize("corner", list(chip_smoke.HYBRID_EDGE_CORNERS))
def test_update_matches_pallas_hybrid_on_edge_operands(corner):
    """chip_smoke.py's hybrid_edge_operands (a window clamped into each
    corner of the map, every kind of range, stacked and on-corner
    endpoints) through the port's integrate_scan and the TPU kernel."""
    op = chip_smoke.hybrid_edge_operands(corner)
    cfg, sensor = op["cfg"], op["sensor"]
    jcfg = GridConfig(**dataclasses.asdict(cfg))
    jsensor = SensorConfig(**dataclasses.asdict(sensor))
    origin_xy = tocc.window_origin_xy(cfg, op["origin_rc"])
    # the TPU kernel takes whole blocks of 8 rows; the update is cell by
    # cell, so it runs on the window with rows appended and those are dropped
    H = op["grid"].shape[0]
    grid8 = np.pad(op["grid"], ((0, -H % 8), (0, 0)))
    ref = np.asarray(
        pallas_dense_update(
            jnp.asarray(grid8), jnp.asarray(op["pose"]),
            jnp.asarray(op["ranges"]), jcfg, jsensor, origin_xy=origin_xy,
            interpret=True, variant="hybrid",
        )
    )[:H]
    out = tocc.integrate_scan(
        torch.from_numpy(op["grid"]), torch.from_numpy(op["pose"]),
        torch.from_numpy(op["ranges"]), cfg, sensor,
        origin_rc=op["origin_rc"],
    ).numpy()
    _assert_update_parity(ref, out, jcfg)
    # what the operands are for: a window cell that gains 2 l_occ or more
    # (stacked endpoints), and beam 90's endpoint on a cell corner
    ranges, pose, res = op["ranges"], op["pose"], cfg.resolution
    r = np.clip(ranges, 0, sensor.max_range)
    hit = (ranges > sensor.min_range) & (ranges < sensor.max_range)
    a = np.asarray(sensor.beam_angles(), np.float32) + pose[2]
    col = np.floor((pose[0] + np.cos(a) * r - origin_xy[0]) / res)
    row = np.floor((pose[1] + np.sin(a) * r - origin_xy[1]) / res)
    win_h, win_w = chip_smoke.HYBRID_EDGE_WINDOW
    inside = hit & (row >= 0) & (row < win_h) & (col >= 0) & (col < win_w)
    cells = row[inside] * win_w + col[inside]
    assert np.unique(cells, return_counts=True)[1].max() >= 2
    ex = pose[0] + r[90] - np.float32(origin_xy[0])
    ey = pose[1] - np.float32(origin_xy[1])
    assert a[90] == 0 and inside[90] and ex / res % 1 == 0 and ey / res % 1 == 0


# Update windows of full SLAM's seed-4 log (bench_configs.fullslam_bench_log,
# seed 4; the frontend's 520^2 window at the pose the JAX package tracks, as
# float32 bits) where atan2 rounds a cell's bearing across a beam slot's
# edge: the reference kernel's bearing (its polynomial arctangent, the cell
# centre one FMA) decides that cell otherwise than torch.atan2 does.
SEED4_SLOT_EDGE = {
    65: (("0x1.f317e6p+2", "0x1.015164p+3", "-0x1.3e76p-5"),
         ("-0x1.5p+2", "-0x1.4p+2")),
    78: (("0x1.2742f8p+3", "0x1.a9a13p+2", "-0x1.c02898p-1"),
         ("-0x1.e66668p+1", "-0x1.966668p+2")),
    119: (("0x1.bdc846p+3", "0x1.994186p+1", "-0x1.81fep-6"),
          ("0x1.ccccc0p-1", "-0x1.3b3334p+3")),
}


@pytest.fixture(scope="module")
def seed4_log():
    from slam2d_tpu_torch.run import bench_configs as bc

    cfg, _ = bc.fullslam_bench_config()
    return cfg, bc.fullslam_bench_log(cfg.sensor, seed=4)


@pytest.mark.parametrize("scan", sorted(SEED4_SLOT_EDGE))
def test_hybrid_bearing_is_the_reference_kernels(seed4_log, scan):
    """The update of a window with a cell on a beam slot's edge equals the
    TPU kernel's (interpret mode) cell for cell: the port computes the
    bearing as the reference does, not with the device's atan2 (whose
    rounding parted the card's run of this log from the CPU's)."""
    cfg, log = seed4_log
    pose_bits, origin_bits = SEED4_SLOT_EDGE[scan]
    pose = np.array([float.fromhex(h) for h in pose_bits], np.float32)
    origin_xy = tuple(float.fromhex(h) for h in origin_bits)
    ranges = np.asarray(log["ranges"][scan], np.float32)
    grid = np.zeros((520, 520), np.float32)
    jcfg = GridConfig(**dataclasses.asdict(cfg.grid))
    jsensor = SensorConfig(**dataclasses.asdict(cfg.sensor))
    ref = np.asarray(pallas_dense_update(
        jnp.asarray(grid), jnp.asarray(pose), jnp.asarray(ranges), jcfg,
        jsensor, origin_xy=origin_xy, interpret=True, variant="hybrid",
    ))
    out = tocc.integrate_scan(
        torch.from_numpy(grid), torch.from_numpy(pose),
        torch.from_numpy(ranges), cfg.grid, cfg.sensor, origin_xy=origin_xy,
    ).numpy()
    np.testing.assert_array_equal(out, ref)


# Update windows of FastSLAM-100's log (bench_configs.pf_bench_log; the
# particle filter's 256^2 window of a 512^2 map at 0.1 m, placed around the
# pose by window_origins; a pose drawn about the true one, as float32 bits)
# where torch.atan2 rounds a cell's bearing across a beam slot's edge that
# the reference kernel's bearing does not cross: one free cell apart.
PF_SLOT_EDGE = {
    380: ("0x1.e08766p+3", "0x1.c2a092p+1", "-0x1.4b347cp-6"),
    508: ("0x1.0e0c4cp+4", "0x1.1dc216p+3", "0x1.6bd292p+0"),
    635: ("0x1.956feap+3", "0x1.ae4d58p+3", "0x1.2d859ap+1"),
}
PF_WINDOW = (256, 256)


@pytest.fixture(scope="module")
def pf_log():
    cfg, _ = bc.pf_bench_config()
    return cfg, bc.pf_bench_log(cfg.sensor)


def _pf_window(pf_log, scan, **grid):
    """(cfg, jcfg, jsensor, pose, ranges, window's top-left cell, its float
    origin, a seeded float32 window) at PF_SLOT_EDGE[scan]; `grid`
    replaces GridConfig fields of both configs."""
    cfg, log = pf_log
    g = dataclasses.replace(cfg.grid, **grid)
    pose = np.array([float.fromhex(h) for h in PF_SLOT_EDGE[scan]],
                    np.float32)
    ranges = np.asarray(log["ranges"][scan], np.float32)
    (r0, c0), (ox, oy) = tupd.window_origins(
        torch.from_numpy(pose[None]), PF_WINDOW, (g.height, g.width),
        (g.origin_x, g.origin_y), g.resolution)
    win = np.random.default_rng(scan).uniform(-3, 3, PF_WINDOW).astype(
        np.float32)
    jcfg = GridConfig(**dataclasses.asdict(g))
    jsensor = SensorConfig(**dataclasses.asdict(cfg.sensor))
    return (g, cfg.sensor, jcfg, jsensor, pose, ranges,
            (int(r0[0]), int(c0[0])), (float(ox[0]), float(oy[0])), win)


@pytest.mark.parametrize("form", ["particles", "window", "carve"])
@pytest.mark.parametrize("scan", sorted(PF_SLOT_EDGE))
def test_ism_bearing_is_the_reference_kernels(pf_log, scan, form):
    """Kernel 1 `ism` at a window with a cell on a beam slot's edge equals
    the TPU kernel's (interpret mode) cell for cell, in each of its
    forms: the particle filter's (a [1, 512, 512] map, the window placed
    by the pose), the frontend step's (the window at a device origin) and
    the carve images' (the map itself the window, l_occ = 0)."""
    g, sensor, jcfg, jsensor, pose, ranges, (r0, c0), origin_xy, win = (
        _pf_window(pf_log, scan, **({"l_occ": 0.0} if form == "carve"
                                    else {})))
    ref = np.asarray(pallas_dense_update(
        jnp.asarray(win), jnp.asarray(pose), jnp.asarray(ranges), jcfg,
        jsensor, origin_xy=origin_xy, interpret=True, variant="ism",
    ))
    kw = tocc.update_constants(g, sensor)
    poses = torch.from_numpy(pose[None])
    if form == "carve":
        out = tupd.update_ism(
            torch.from_numpy(win[None].copy()), poses,
            torch.from_numpy(ranges), region=PF_WINDOW, origin_xy=origin_xy,
            **kw)[0]
    else:
        maps = torch.zeros((1, g.height, g.width))
        window = (0, slice(r0, r0 + PF_WINDOW[0]),
                  slice(c0, c0 + PF_WINDOW[1]))
        maps[window] = torch.from_numpy(win)
        extra = ({} if form == "particles" else
                 {"origin": torch.tensor([r0, c0], dtype=torch.int32)})
        out = tupd.update_ism(
            maps, poses, torch.from_numpy(ranges), region=PF_WINDOW,
            origin_xy=(g.origin_x, g.origin_y), **kw, **extra)[window]
    assert (out.numpy() != win).sum() > 1000
    np.testing.assert_array_equal(out.numpy(), ref)


def _jax_ray_tables(g, sensor, pose, ranges, ox, oy):
    """The TPU kernel's wrapper's beam tables (pallas_update.py:321-370)
    for `g` and `sensor`, jitted, padded to 8 beams as there."""
    def tables(pose, ranges, ox, oy):
        res, ms = g.resolution, sensor.max_range
        r = jnp.clip(ranges, 0.0, ms)
        valid = (ranges > sensor.min_range) & jnp.isfinite(ranges)
        hit = valid & (ranges < ms)
        a = (jnp.asarray(np.asarray(sensor.beam_angles()), jnp.float32)
             + pose[2])
        dirx, diry = jnp.cos(a), jnp.sin(a)
        r_free = jnp.maximum(r - res, 0.0) * valid
        w_free = valid / jnp.maximum(r_free / g.ray_samples, res)
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

    return np.array(jax.jit(tables)(jnp.asarray(pose), jnp.asarray(ranges),
                                    jnp.float32(ox), jnp.float32(oy)))


def _jax_tile_chunks(g, sensor, pose, ranges, shape, ox, oy):
    """The TPU kernel's own beam clip (pallas_update.py:141-174) on the
    port's tile lattice: [H / 8, W / 16, 2] chunks [c_lo, c_hi) of each of
    the kernel's 32 x 128 blocks (a window whose sides are multiples of
    them), repeated over the _RAY_TILE tiles it holds, for
    update_ray_plain's `bounds`. The bearing is the kernel's polynomial
    one (atan2_ref)."""
    from slam2d_tpu_torch.core.numerics import atan2_ref, fma_f32

    H, W = shape
    res, B = g.resolution, sensor.n_beams
    step = sensor.fov_rad / (B - 1)
    occ_tol = 0.75 * res
    r = np.clip(ranges, 0.0, sensor.max_range)
    valid = (ranges > sensor.min_range) & np.isfinite(ranges)
    rmax_t = max(float(np.where(valid, r, -1.0).max()), 0.0) + occ_tol
    n_chunks = -(-B // 8)
    px, py, pth = (float(v) for v in pose)
    col = torch.arange(W, dtype=torch.float32)
    row = torch.arange(H, dtype=torch.float32)
    cx = (fma_f32(col + 0.5, res, ox) - px)[None, :].expand(H, W)
    cy = (fma_f32(row + 0.5, res, oy) - py)[:, None].expand(H, W)
    phi = atan2_ref(cy, cx) - pth - sensor.angle_min
    phi = torch.remainder(phi + math.pi, 2 * math.pi) - math.pi
    d2 = cx * cx + cy * cy
    out = np.zeros((H // 32, W // 128, 2), np.int64)
    for i in range(H // 32):
        for j in range(W // 128):
            blk = (slice(32 * i, 32 * i + 32), slice(128 * j, 128 * j + 128))
            lo, hi = float(phi[blk].min()), float(phi[blk].max())
            dmin = math.sqrt(float(d2[blk].min()))
            thr = max(0.5 * step, occ_tol / max(dmin, 1e-6)) + 0.25 * step
            c_lo = math.floor((lo - thr) / (8 * step))
            c_hi = math.floor((hi + thr) / (8 * step)) + 1
            if hi - lo > math.pi:
                c_lo, c_hi = 0, n_chunks
            c_lo = min(max(c_lo, 0), n_chunks)
            c_hi = min(max(c_hi, 0), n_chunks)
            if float(d2[blk].min()) > rmax_t * rmax_t:
                c_hi = c_lo
            out[i, j] = c_lo, c_hi
    ty, tx = tupd._RAY_TILE
    return torch.from_numpy(
        out.repeat(32 // ty, axis=0).repeat(128 // tx, axis=1))


@pytest.mark.parametrize("scan", sorted(PF_SLOT_EDGE))
def test_ray_chord_is_the_reference_kernels(pf_log, scan):
    """Kernel 1 `ray`'s plain version on the reference's beam tables at the
    slot-edge windows: summed over the chunks the TPU kernel's own clip
    keeps, both channels are its bits (XLA contracts the cell centre, the
    chord's t and ct and each chunk's sum into FMAs; with the products
    rounded apart the free channel was 2e-4 off). The port's clip keeps
    every beam that touches a tile; the reference's drops the chords of
    some beams through cells within 2 res of the sensor on a block that
    does not hold it (at scan 635 one cell by 2 l_free: ROADMAP queue 3),
    so the port's full sum differs from the reference there and only
    there."""
    g, sensor, jcfg, jsensor, pose, ranges, _, (ox, oy), win = _pf_window(
        pf_log, scan)
    rays = torch.from_numpy(_jax_ray_tables(g, sensor, pose, ranges, ox, oy))
    clip = _jax_tile_chunks(g, sensor, pose, ranges, PF_WINDOW, ox, oy)
    H, W = PF_WINDOW
    centre = ((np.arange(W) + 0.5) * g.resolution + ox - pose[0])[None, :]
    centre = np.hypot(centre, ((np.arange(H) + 0.5) * g.resolution + oy
                               - pose[1])[:, None])
    for l_free, l_occ in ((g.l_free, 0.0), (0.0, g.l_occ),
                          (g.l_free, g.l_occ)):
        ref = np.asarray(pallas_dense_update(
            jnp.asarray(win), jnp.asarray(pose), jnp.asarray(ranges),
            dataclasses.replace(jcfg, l_free=l_free, l_occ=l_occ), jsensor,
            origin_xy=(ox, oy), interpret=True, variant="ray",
        ))
        full, clipped = (tupd.update_ray_plain(
            torch.from_numpy(win), torch.from_numpy(pose), rays,
            origin_xy=(ox, oy), resolution=g.resolution, l_free=l_free,
            l_occ=l_occ, l_clamp=g.l_clamp, bounds=b,
        ).numpy() for b in (None, clip))
        assert (full != win).sum() > 100
        np.testing.assert_array_equal(clipped, ref)
        assert (centre[full != ref] < 2 * g.resolution).all()


@pytest.mark.parametrize("scan", sorted(PF_SLOT_EDGE))
def test_ray_chunk_bounds_drop_no_beam_at_slot_edge_windows(pf_log, scan):
    """The `ray` kernel's tile clip (ray_chunk_bounds) at the slot-edge
    windows, on the port's own tables: the clipped sum has the bits of the
    clip-free loop over every beam, and the clip skips chunks."""
    g, sensor, _, _, pose, ranges, _, origin_xy, win = _pf_window(
        pf_log, scan)
    kw = tocc.update_constants(g, sensor)
    pose_t, ranges_t = torch.from_numpy(pose), torch.from_numpy(ranges)
    bounds = tupd.ray_chunk_bounds(
        pose_t, ranges_t, PF_WINDOW, origin_xy=origin_xy,
        resolution=g.resolution, min_range=kw["min_range"],
        max_range=kw["max_range"], angle_min=kw["angle_min"], step=kw["step"])
    rays = tupd.ray_tables(
        pose_t, ranges_t, tocc.beam_angles(sensor, torch.device("cpu")),
        origin_xy=origin_xy, resolution=g.resolution,
        min_range=kw["min_range"], max_range=kw["max_range"],
        ray_samples=g.ray_samples)
    full, clipped = (tupd.update_ray_plain(
        torch.from_numpy(win), pose_t, rays, origin_xy=origin_xy,
        resolution=g.resolution, l_free=g.l_free, l_occ=g.l_occ,
        l_clamp=g.l_clamp, bounds=b) for b in (None, bounds))
    assert (full.numpy() != win).sum() > 1000
    np.testing.assert_array_equal(clipped.numpy(), full.numpy())
    trips = (bounds[..., 1] - bounds[..., 0]).sum().item()
    assert trips < 0.5 * bounds[..., 0].numel() * (rays.shape[1] // 8)


def test_fma_f32_rounds_once():
    """numerics.fma_f32 is the correctly rounded float32 a * b + c (the
    card's fmaf), against exact rationals at random operands over 60
    binades and on a float32 midpoint that a float64 sum rounded to nearest
    would reach (1 + 2^-23 + 2^-24 - 2^-70: below it, so 1 + 2^-23)."""
    from fractions import Fraction

    from slam2d_tpu_torch.core.numerics import fma_f32

    def rn32(x):
        f = np.float32(float(x))
        near = (f, np.nextafter(f, np.float32(np.inf)),
                np.nextafter(f, np.float32(-np.inf)))
        return min(near, key=lambda y: (abs(Fraction(float(y)) - x),
                                        int(np.float32(y).view(np.int32)) & 1))

    one = np.float32(1 + 2**-23)
    a, b, c = (torch.tensor([v], dtype=torch.float32)
               for v in (one, 2**-24 * (1 - 2**-23), one))
    assert float(fma_f32(a, b, c)) == 1 + 2**-23
    rng = np.random.default_rng(7)
    ops = [(rng.normal(size=3000) * 2.0 ** rng.integers(-30, 30, 3000))
           .astype(np.float32) for _ in range(3)]
    out = fma_f32(*(torch.from_numpy(x) for x in ops)).numpy()
    want = [rn32(Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z)))
            for x, y, z in zip(*ops)]
    np.testing.assert_array_equal(out, np.array(want, np.float32))


def test_atan2_ref_is_the_reference_polynomial():
    """numerics.atan2_ref against the TPU kernel's _atan2 under jit on the
    CPU, bit for bit, at the cell centres of a 520^2 window at 0.05 m and
    at random points of every quadrant; torch.atan2 differs from it in the
    last bits at many of them."""
    from slam2d_tpu.ops.pallas_update import _atan2
    from slam2d_tpu_torch.core.numerics import atan2_ref

    rng = np.random.default_rng(5)
    c = (np.arange(520, dtype=np.float32) + np.float32(0.5)) * np.float32(
        0.05) - np.float32(13.02)
    ys = [np.broadcast_to(c[:, None], (520, 520)),
          rng.normal(0, 5, 100_000).astype(np.float32)]
    xs = [np.broadcast_to(c[None, :] + np.float32(0.013), (520, 520)),
          rng.normal(0, 5, 100_000).astype(np.float32)]
    for y, x in zip(ys, xs):
        y, x = np.ascontiguousarray(y), np.ascontiguousarray(x)
        ref = np.asarray(jax.jit(_atan2)(y, x))
        out = atan2_ref(torch.from_numpy(y), torch.from_numpy(x)).numpy()
        np.testing.assert_array_equal(out, ref)
        assert (torch.atan2(torch.from_numpy(y), torch.from_numpy(x))
                .numpy() != ref).mean() > 0.1


def test_update_window_with_integer_origin():
    gcfg = dataclasses.replace(GCFG, height=512, width=512)
    full = np.random.default_rng(2).uniform(-3, 3, (512, 512)).astype(
        np.float32
    )
    r0, c0 = 100, 84
    win = full[r0 : r0 + 272, c0 : c0 + 272]
    ranges = _ranges("scan")
    ref = np.asarray(
        jocc.integrate_scan(
            jnp.asarray(win), jnp.asarray(POSE), jnp.asarray(ranges), gcfg,
            SENSOR, origin_rc=(jnp.int32(r0), jnp.int32(c0)),
        )
    )
    out = tocc.integrate_scan(
        torch.from_numpy(np.ascontiguousarray(win)), torch.from_numpy(POSE),
        torch.from_numpy(ranges), to_port(gcfg), to_port(SENSOR),
        origin_rc=(r0, c0),
    ).numpy()
    _assert_update_parity(ref, out, gcfg)
    assert (out != win).sum() > 1000


def test_occupancy_helpers_match_jax():
    xy = np.random.default_rng(3).uniform(-5, 25, (50, 2)).astype(np.float32)
    for name in ("world_to_cell_float", "world_to_cell"):
        # jitted, as the JAX frontend runs it: XLA turns the division by
        # the cell size into a multiplication by its reciprocal
        fn = jax.jit(getattr(jocc, name), static_argnums=1)
        ref = np.asarray(fn(jnp.asarray(xy), GCFG))
        out = getattr(tocc, name)(torch.from_numpy(xy), to_port(GCFG)).numpy()
        np.testing.assert_array_equal(out, ref)
    ranges = _ranges("nan")
    pts_j, valid_j = jocc.scan_endpoints_local(jnp.asarray(ranges), SENSOR)
    pts_t, valid_t = tocc.scan_endpoints_local(
        torch.from_numpy(ranges), to_port(SENSOR)
    )
    np.testing.assert_array_equal(valid_t.numpy(), np.asarray(valid_j))
    np.testing.assert_allclose(pts_t.numpy(), np.asarray(pts_j), atol=1e-5)
    np.testing.assert_array_equal(
        tocc.beam_angles(to_port(SENSOR), torch.device("cpu")).numpy(),
        np.asarray(jocc.beam_angles(SENSOR)),
    )
    lo = np.linspace(-12, 12, 97, dtype=np.float32)
    np.testing.assert_allclose(
        tocc.occupancy_prob(torch.from_numpy(lo)).numpy(),
        np.asarray(jocc.occupancy_prob(jnp.asarray(lo))), atol=1e-7,
    )
    g = tocc.make_grid(to_port(GCFG), torch.device("cpu"))
    assert g.shape == (256, 256) and g.dtype == torch.float32
    assert not g.any()


@pytest.mark.parametrize(
    "gcfg,sensor",
    [
        (dataclasses.replace(GCFG, update_impl="pallas_ray"),
         SensorConfig(n_beams=270, fov_rad=1.5 * math.pi)),
        (GCFG, SensorConfig(n_beams=270, fov_rad=1.5 * math.pi)),
    ],
)
def test_unported_update_paths_raise(gcfg, sensor):
    """A kernel named explicitly at a field of view wider than pi (the
    sampled-ray and dense updates run since they were ported:
    tests/test_torch_sparse_update.py)."""
    with pytest.raises(NotImplementedError):
        tocc.integrate_scan(
            torch.zeros(64, 64), torch.from_numpy(POSE),
            torch.ones(sensor.n_beams), to_port(gcfg), to_port(sensor),
        )


@pytest.mark.parametrize(
    "bad",
    ["grid_dtype", "pose_shape", "ranges_device", "noncontiguous", "device"],
)
def test_update_wrapper_rejects_bad_input(bad):
    grid = torch.zeros(32, 32)
    pose = torch.from_numpy(POSE)
    ranges = torch.ones(180)
    angles = tocc.beam_angles(to_port(SENSOR), torch.device("cpu"))
    if bad == "grid_dtype":
        grid = grid.double()
    elif bad == "pose_shape":
        pose = torch.zeros(4)
    elif bad == "ranges_device":
        ranges = ranges.to("meta")
    elif bad == "noncontiguous":
        grid = torch.zeros(32, 64)[:, ::2]
    else:
        grid, pose, ranges, angles = (
            t.to("meta") for t in (grid, pose, ranges, angles)
        )
    with pytest.raises(ValueError):
        tupd.update_hybrid(
            grid, pose, ranges, angles, origin_xy=(0.0, 0.0),
            resolution=0.1, step=0.01, angle_min=-1.5, min_range=0.1,
            max_range=12.0, l_free=-0.4, l_occ=0.85, l_clamp=10.0,
        )
