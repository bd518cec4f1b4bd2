"""PyTorch port: the particle filter's kernels against the JAX package's
TPU kernels, run on the CPU in interpret mode (the port's plain versions).

- ISM update (ops/update.py:update_ism) against the JAX particle filter's
  windowed update, pallas_dense_update(variant="ism"), on float32 and
  bfloat16 maps, with windows clamped at the map's edges: bit-exact (the
  port computes the cell centre and the bearing as XLA compiles the TPU
  kernel: one FMA, its polynomial atan2).
- window field (ops/field.py) against fused_window_field, with origins off
  every edge of the map: float32 within 1e-6; a bfloat16 field is the
  float32 one rounded once, so it may differ by one bf16 ulp where the
  float32 sums differ in their last bit.
- shift stack (ops/stack.py) and row gather (ops/gather.py): bit-exact.
- the shapes that select each variant of the field and gather kernels
  (16-byte aligned row pitch and field rows or not; 9 taps or 13; rows of
  16 k, 4 k and odd bytes; a misaligned base): the plain versions, which
  the kernels are held against on the GPU, against the JAX package there.
"""

import dataclasses
import math
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam2d_tpu.config import FrontendConfig, GridConfig, MatcherConfig, PFConfig
from slam2d_tpu.grid.window import blur_halo_cells
from slam2d_tpu.match.correlative import _gaussian_kernel_1d
from slam2d_tpu.ops.pallas_field import fused_field_supported, fused_window_field
from slam2d_tpu.ops.pallas_gather import gather_rows_pallas
from slam2d_tpu.ops.pallas_stack import shift_stack_pallas
from slam2d_tpu.pf import fastslam as jfs
from slam2d_tpu_torch.ops import field as tfield
from slam2d_tpu_torch.ops import gather as tgather
from slam2d_tpu_torch.ops import stack as tstack
from slam2d_tpu_torch.ops import update as tupd
from slam2d_tpu_torch.pf import fastslam as tfs
from torch_parity import SENSOR, synth_ranges, to_port

import chip_smoke

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]

GCFG = GridConfig(
    height=320, width=320, resolution=0.1, center_x=10.0, center_y=10.0,
    update_impl="pallas",
)
CFG = FrontendConfig(sensor=SENSOR, grid=GCFG)
# one pose whose 256^2 update window clamps at the low edges, one inside,
# one clamping at the high edges
POSES = np.array(
    [[0.5, 0.6, 0.3], [10.2, 9.7, -1.1], [19.4, 19.3, 2.5]], np.float32
)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _maps(P, H, W, seed, jdtype, lo=-5.0, hi=5.0):
    """Seeded maps as a (JAX array, torch tensor) pair of one dtype."""
    m = np.random.default_rng(seed).uniform(lo, hi, (P, H, W)).astype(np.float32)
    jm = jnp.asarray(m).astype(jdtype)
    bits = np.array(jm.astype(jnp.float32))  # exact for bf16 values
    tdtype = DTYPES["bfloat16" if jdtype == jnp.bfloat16 else "float32"][1]
    return jm, torch.from_numpy(bits).to(tdtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ism_update_matches_jax_windowed_update(dtype):
    jdtype, _ = DTYPES[dtype]
    jm, tm = _maps(3, 320, 320, 0, jdtype)
    ranges = synth_ranges(POSES[1])
    ranges[::23] = np.nan  # invalid beams
    fn = jax.jit(jax.vmap(
        lambda g, p: jfs._windowed_update(g, p, jnp.asarray(ranges), CFG)
    ))
    ref = np.asarray(fn(jm, jnp.asarray(POSES)).astype(jnp.float32))
    before = tm.float().numpy().copy()
    out = tfs._update_all(
        tm, torch.from_numpy(POSES), torch.from_numpy(ranges), to_port(CFG),
        to_port(PFConfig(n_particles=3)),
    )
    assert out is tm and tm.dtype == DTYPES[dtype][1]   # in place
    out = tm.float().numpy()
    np.testing.assert_array_equal(out, ref)
    for p in range(3):
        assert (out[p] != before[p]).sum() > 1000


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["pallas", "auto"])
def test_integrate_scan_ism_matches_jax(impl, dtype):
    """integrate_scan of one map window at a clamped integer origin:
    update_impl "pallas", and "auto" in the particle filter's context
    (auto_ctx="pf", which resolves to it as on the accelerator), against
    the JAX package's integrate_scan with "pallas" (interpret mode)."""
    from slam2d_tpu.grid.occupancy import integrate_scan
    from slam2d_tpu_torch.grid import occupancy as tocc

    jdtype, tdtype = DTYPES[dtype]
    jm, tm = _maps(1, 320, 320, 4, jdtype)
    r0 = c0 = 64
    win_j, win_t = jm[0, r0:, c0:], tm[0, r0:, c0:].contiguous()
    ranges = synth_ranges(POSES[2])
    ref = np.asarray(integrate_scan(
        win_j, jnp.asarray(POSES[2]), jnp.asarray(ranges), GCFG, SENSOR,
        origin_rc=(jnp.int32(r0), jnp.int32(c0)),
    ).astype(jnp.float32))
    gcfg = to_port(dataclasses.replace(GCFG, update_impl=impl))
    sensor = to_port(SENSOR)
    assert tocc.resolve_update_impl(gcfg, sensor, auto_ctx="pf") == "pallas"
    out = tocc.integrate_scan(
        win_t, torch.from_numpy(POSES[2]), torch.from_numpy(ranges), gcfg,
        sensor, origin_rc=(r0, c0), auto_ctx="pf",
    )
    assert out.dtype == tdtype and out.data_ptr() != win_t.data_ptr()
    out = out.float().numpy()
    np.testing.assert_array_equal(out, ref)
    assert (out != win_t.float().numpy()).sum() > 1000


# ---- the ISM kernel's candidate boxes of the occupied channel ------------


def test_ism_box_side_is_the_kernels():
    """ops/update.py:_ISM_BOX, the side of the plain twin's boxes, is the
    BOX that csrc/update_ism.cu compiles with."""
    src = (ROOT / "slam2d_tpu_torch" / "csrc" / "update_ism.cu").read_text()
    sides = re.findall(r"constexpr int BOX = (\d+);", src)
    assert sides == [str(tupd._ISM_BOX)]


@pytest.mark.parametrize("window", sorted(chip_smoke.ISM_EDGE_WINDOWS))
@pytest.mark.parametrize("sensor_name", sorted(chip_smoke.ISM_EDGE_SENSORS))
def test_ism_occ_boxes_hold_every_occupied_pair(sensor_name, window):
    """Every (beam, cell) pair that meets the ISM update's occupied
    predicate (the plain version's float32 operations) lies in the beam's
    candidate box (ops/update.py:ism_occ_boxes, the kernel's), and its
    cell center lies within 2 * occ_tol of the beam's endpoint (the bound
    the box widens by one cell), on chip_smoke.py's ism_edge_operands:
    seeded poses (headings past pi included) and scans with ranges just
    above min_range, at occ_tol above it, under occ_tol, invalid and
    without a hit."""
    op = chip_smoke.ism_edge_operands(sensor_name, window)
    sensor, side, win = op["sensor"], op["side"], op["win"]
    poses, ranges = op["poses"], op["ranges"]
    res, origin_xy = op["resolution"], op["origin_xy"]
    B = sensor.n_beams
    occ_tol = tupd.ism_occ_tol(res)
    pose_t, ranges_t = torch.from_numpy(poses), torch.from_numpy(ranges)
    kw = dict(origin_xy=origin_xy, resolution=res, angle_min=sensor.angle_min)
    step = sensor.fov_rad / (B - 1)
    boxes, can = tupd.ism_occ_boxes(
        pose_t, ranges_t, (win, win), (side, side), step=step,
        min_range=sensor.min_range, max_range=sensor.max_range, **kw,
    )
    d, phi = tupd.ism_cell_polar(pose_t, (win, win), (side, side), **kw)
    r_hit, _ = tupd._beam_tables(ranges_t, sensor.min_range, sensor.max_range)
    tol = torch.full_like(d, occ_tol) / torch.clamp(d, min=1e-6)
    (r0, c0), (ox, oy) = tupd.window_origins(
        pose_t, (win, win), (side, side), origin_xy, res
    )
    n_pairs, n_near, n_past_pi = 0, 0, 0
    for b in range(B):
        pred = (torch.abs(phi - np.float32(b * np.float32(step))) <= tol) & (
            torch.abs(d - r_hit[b]) <= occ_tol
        )
        if not pred.any():
            continue
        assert bool(can[:, b].all())
        p, r, c = (t.numpy() for t in torch.nonzero(pred, as_tuple=True))
        top, left = boxes[p, b, 0].numpy(), boxes[p, b, 1].numpy()
        inside = (r >= top) & (r < top + tupd._ISM_BOX) & (c >= left) & (
            c < left + tupd._ISM_BOX
        )
        assert inside.all(), (
            f"beam {b}: {(~inside).sum()} occupied cells outside its box, "
            f"e.g. particle {p[~inside][0]} cell {r[~inside][0], c[~inside][0]}"
        )
        # float64 geometry: the endpoint and the marked cells' centers
        px, py, pth = poses[p].astype(np.float64).T
        a = pth + sensor.angle_min + b * step
        ex = px + float(r_hit[b]) * np.cos(a)
        ey = py + float(r_hit[b]) * np.sin(a)
        cx = ox.double().numpy()[p] + (c + 0.5) * res
        cy = oy.double().numpy()[p] + (r + 0.5) * res
        dist = np.hypot(cx - ex, cy - ey)
        assert dist.max() <= 2 * occ_tol * (1 + 1e-5) + 1e-6, dist.max()
        n_pairs += p.size
        n_near += p.size if float(r_hit[b]) <= sensor.min_range + occ_tol else 0
        n_past_pi += p.size if b * step > np.pi else 0
    assert n_pairs > 500 and n_near > 0
    assert (n_past_pi > 0) == (sensor.fov_rad > np.pi)
    if window == "clamped":   # a window at each edge of the map
        assert {0, side - win} <= set(r0.tolist())
        assert {0, side - win} <= set(c0.tolist())


def test_cell_center_world_matches_jax():
    """Bit-exact against the JAX function run eagerly; within one float32
    ulp when jitted, where XLA contracts the multiply-add into an FMA."""
    from slam2d_tpu.grid.occupancy import cell_center_world
    from slam2d_tpu_torch.grid import occupancy as tocc

    rc = np.random.default_rng(6).integers(-40, 360, (64, 2)).astype(np.int32)
    out = tocc.cell_center_world(torch.from_numpy(rc), to_port(GCFG)).numpy()
    np.testing.assert_array_equal(
        out, np.asarray(cell_center_world(jnp.asarray(rc), GCFG))
    )
    jitted = jax.jit(cell_center_world, static_argnums=1)
    ref = np.asarray(jitted(jnp.asarray(rc), GCFG))
    np.testing.assert_allclose(out, ref, rtol=0, atol=np.spacing(np.float32(64)))


def test_ism_windows_follow_window_origin():
    """The kernel's per-particle window origin is grid/window.py's
    window_origin of the pose's cell (clamped), and its float origin is
    ox + f32(c0) * res."""
    from slam2d_tpu.grid.occupancy import world_to_cell
    from slam2d_tpu.grid.window import window_origin

    (r0, c0), (ox, oy) = tupd.window_origins(
        torch.from_numpy(POSES), (256, 256), (320, 320),
        (GCFG.origin_x, GCFG.origin_y), GCFG.resolution,
    )
    for p in range(3):
        center = jax.jit(world_to_cell, static_argnums=1)(
            jnp.asarray(POSES[p, :2]), GCFG
        )
        jr, jc = window_origin(center, 256, 320, 320)
        assert (int(r0[p]), int(c0[p])) == (int(jr), int(jc))
        assert float(ox[p]) == float(
            np.float32(GCFG.origin_x) + np.float32(int(jc)) * np.float32(0.1)
        )
    assert (int(r0[0]), int(c0[0])) == (0, 0)
    assert (int(r0[2]), int(c0[2])) == (64, 64)


def _field_args(mcfg, res):
    hw = blur_halo_cells(mcfg, res)
    taps = _gaussian_kernel_1d(mcfg.sigma_m / res, hw)
    thr = mcfg.free_threshold
    return taps, dict(
        inv_sat=1.0 / mcfg.occ_evidence_sat,
        free_logit=math.log(thr / (1.0 - thr)),
        free_penalty=mcfg.free_penalty,
    )


@pytest.mark.parametrize(
    "map_dtype,out_dtype",
    [("float32", "float32"), ("bfloat16", "float32"),
     ("bfloat16", "bfloat16")],
)
def test_window_field_matches_fused_window_field(map_dtype, out_dtype):
    P, Hm, Wm, win = 5, 128, 256, 96
    mcfg = MatcherConfig(sigma_m=0.1)
    jm, tm = _maps(P, Hm, Wm, 1, DTYPES[map_dtype][0], -4.0, 4.0)
    # interior, off the top-left, off the bottom-right, half off the
    # bottom, beyond the top-right corner
    origins = np.array(
        [[10, 50], [-20, -30], [Hm - 40, Wm - 40], [Hm - win // 2, 5],
         [-90, Wm - 8]], np.int32,
    )
    taps, kw = _field_args(mcfg, 0.1)
    assert fused_field_supported(Hm, Wm, win, 8)
    ref = fused_window_field(
        jm, jnp.asarray(origins), win, tuple(float(t) for t in taps),
        kw["inv_sat"], kw["free_logit"], kw["free_penalty"],
        out_dtype=DTYPES[out_dtype][0], interpret=True,
    )
    ref = np.asarray(ref.astype(jnp.float32))
    out = tfield.window_field(
        tm, torch.from_numpy(origins), win, taps,
        out_dtype=DTYPES[out_dtype][1], **kw,
    )
    assert out.dtype == DTYPES[out_dtype][1] and out.shape == (P, win, win)
    out = out.float().numpy()
    if out_dtype == "float32":
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)
    else:
        diff = np.abs(out - ref)
        assert (diff != 0).mean() <= 1e-3
        assert (diff <= 2.0 ** -8 * np.maximum(np.abs(ref), 2.0 ** -8)).all()
    # off the map and beyond the blur halo (4 cells) of its edge
    assert (out[1, :16, :] == 0).all() and (out[1, :, :26] == 0).all()
    assert np.abs(out[0]).max() > 0.5


def _jax_field(jm, origins, win, mcfg, jout):
    """The JAX package's field of windows at unclamped `origins`, as its
    shared refine builds it: the fused TPU kernel (interpret mode) where
    fused_field_supported allows, else aligned_window +
    build_search_space per particle (on the window widened to float32,
    the arithmetic of the fused kernel and of the port)."""
    from slam2d_tpu.match.correlative import build_search_space
    from slam2d_tpu.pf.shared_refine import aligned_window

    P, Hm, Wm = jm.shape
    res = 0.1
    hw = blur_halo_cells(mcfg, res)
    taps, kw = _field_args(mcfg, res)
    if fused_field_supported(Hm, Wm, win, max(8, (hw + 7) // 8 * 8)):
        return "fused", fused_window_field(
            jm, jnp.asarray(origins), win, tuple(float(t) for t in taps),
            kw["inv_sat"], kw["free_logit"], kw["free_penalty"],
            out_dtype=jout, interpret=True,
        )
    gcfg = GridConfig(height=Hm, width=Wm, resolution=res)
    # a prior at the center of the window's center cell
    center = origins[:, ::-1].astype(np.float64) + win // 2 + 0.5
    priors = np.concatenate(
        [center * res + (gcfg.origin_x, gcfg.origin_y), np.zeros((P, 1))],
        axis=1,
    ).astype(np.float32)

    def one(g, prior):
        gw, _ = aligned_window(g, prior, gcfg, win)
        return build_search_space(gw.astype(jnp.float32), mcfg, res).astype(jout)

    return "xla", jax.jit(jax.vmap(one))(jm, jnp.asarray(priors))


@pytest.mark.parametrize(
    "map_dtype,out_dtype",
    [("float32", "float32"), ("bfloat16", "float32"),
     ("bfloat16", "bfloat16")],
)
@pytest.mark.parametrize("sigma_m", [0.1, 0.2])       # 9 and 13 taps
@pytest.mark.parametrize("Wm,win", [(256, 96), (203, 100), (128, 44)])
def test_window_field_at_variant_shapes(Wm, win, sigma_m, map_dtype, out_dtype):
    """The shapes that select each variant of the field kernel (the maps'
    row pitch and the field's rows a multiple of 16 bytes or not, 9 taps
    or another count), origins off every edge and wholly off the map:
    the tolerance of test_window_field_matches_fused_window_field."""
    P, Hm = 7, 160
    mcfg = MatcherConfig(sigma_m=sigma_m)
    jm, tm = _maps(P, Hm, Wm, 5, DTYPES[map_dtype][0], -4.0, 4.0)
    origins = np.array(
        [[10, 20], [-20, -30], [Hm - 40, Wm - 40], [Hm - win // 2, 5],
         [3, Wm - 10], [5, 3 - win], [-win - 4, Wm - 8]], np.int32,
    )
    taps, kw = _field_args(mcfg, 0.1)
    assert len(taps) == (9 if sigma_m == 0.1 else 13)
    path, ref = _jax_field(jm, origins, win, mcfg, DTYPES[out_dtype][0])
    assert path == ("fused" if (Wm, win) == (256, 96) else "xla")
    ref = np.asarray(ref.astype(jnp.float32))
    out = tfield.window_field(
        tm, torch.from_numpy(origins), win, taps,
        out_dtype=DTYPES[out_dtype][1], **kw,
    )
    assert out.dtype == DTYPES[out_dtype][1] and out.shape == (P, win, win)
    out = out.float().numpy()
    if out_dtype == "float32":
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)
    else:
        diff = np.abs(out - ref)
        assert (diff != 0).mean() <= 1e-3
        assert (diff <= 2.0 ** -8 * np.maximum(np.abs(ref), 2.0 ** -8)).all()
    assert (out[6] == 0).all()                  # wholly off the map
    assert np.abs(out[0]).max() > 0.5


def test_aligned_origins_match_jax_aligned_window():
    """The port's window origins and anchors against the JAX package's
    aligned_window: the window read at the origin (cells off the map 0)
    is its window, bit for bit."""
    from slam2d_tpu.pf.shared_refine import aligned_window as jaligned
    from slam2d_tpu_torch.pf.shared_refine import aligned_origins

    gcfg = GridConfig(height=64, width=128, resolution=0.1)
    g = np.random.default_rng(2).uniform(-3, 3, (64, 128)).astype(np.float32)
    fn = jax.jit(jaligned, static_argnums=(2, 3))
    priors = np.array(
        [[1.0, 0.5, 0.3], [0.2, 0.1, 0.3], [12.0, 6.0, 0.3], [-3.0, 2.0, 0.3]],
        np.float32,
    )
    origins, anchors = aligned_origins(
        torch.from_numpy(priors), to_port(gcfg), 32
    )
    assert origins.dtype == torch.int32 and origins.shape == (4, 2)
    windows = tfield.unclamped_windows(
        torch.from_numpy(g)[None].expand(4, -1, -1), origins, 32
    )
    for p, prior in enumerate(priors):
        ref_w, ref_a = fn(jnp.asarray(g), jnp.asarray(prior), gcfg, 32)
        np.testing.assert_array_equal(windows[p].numpy(), np.asarray(ref_w))
        # XLA's CPU backend fuses the anchor's ox + (col + 0.5) * res into
        # one FMA; the port rounds the product and the sum as written
        # (apart by at most one float32 ulp of the operands, |ox| = 6.4)
        np.testing.assert_allclose(
            anchors[p].numpy(), np.asarray(ref_a), rtol=0, atol=1e-6
        )


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("win,R,C", [(48, 5, 5), (40, 3, 7)])
def test_shift_stack_matches_pallas_bit_exact(dtype, win, R, C):
    jdtype, _ = DTYPES[dtype]
    jE, tE = _maps(3, win, win, 3, jdtype, 0.0, 1.0)
    ref = np.asarray(
        shift_stack_pallas(jE, R, C, interpret=True).astype(jnp.float32)
    )
    out = tstack.shift_stack(tE, R, C)
    assert out.dtype == tE.dtype and out.shape == (3, R * C, win, win)
    np.testing.assert_array_equal(out.float().numpy(), ref)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gather_rows_matches_pallas_bit_exact(dtype):
    jdtype, _ = DTYPES[dtype]
    jx, tx = _maps(6, 16, 64, 4, jdtype)
    anc = np.array([5, 5, 0, 2, 2, 2], np.int32)   # repeats, one row kept
    ref = np.asarray(
        gather_rows_pallas(jx, jnp.asarray(anc), interpret=True)
        .astype(jnp.float32)
    )
    out = tgather.gather_rows(tx, torch.from_numpy(anc))
    assert out.dtype == tx.dtype and out.data_ptr() != tx.data_ptr()
    np.testing.assert_array_equal(out.float().numpy(), ref)


GATHER_ANCESTORS = {
    "sorted": lambda P, rng: np.sort(rng.integers(0, P, P)),
    "unsorted": lambda P, rng: rng.integers(0, P, P),
    "identity": lambda P, rng: np.arange(P),
    "collapsed": lambda P, rng: np.full(P, 7),
}


@pytest.mark.parametrize("ancestors", sorted(GATHER_ANCESTORS))
@pytest.mark.parametrize("misaligned", [False, True])
@pytest.mark.parametrize("row_bytes", [2 * 16384 + 16, 4004, 1001])
def test_gather_rows_at_variant_shapes(row_bytes, misaligned, ancestors):
    """Rows of 16 k, 4 k and odd bytes (the alignments that select the
    gather kernel's variants), at an aligned base or one byte into a
    larger buffer: bit-exact to gather_rows_pallas and to numpy's take."""
    P = 19
    rng = np.random.default_rng(row_bytes)
    x = rng.integers(0, 256, (P, row_bytes)).astype(np.uint8)
    anc = GATHER_ANCESTORS[ancestors](P, rng).astype(np.int32)
    tx = torch.from_numpy(x)
    if misaligned:
        buf = torch.zeros(x.size + 16, dtype=torch.uint8)
        tx = buf[1:1 + x.size].view(P, row_bytes).copy_(tx)
        assert tx.is_contiguous() and tx.data_ptr() % 2 == 1
    out = tgather.gather_rows(tx, torch.from_numpy(anc))
    assert out.dtype == torch.uint8 and out.data_ptr() != tx.data_ptr()
    ref = np.asarray(
        gather_rows_pallas(jnp.asarray(x), jnp.asarray(anc), interpret=True)
    )
    np.testing.assert_array_equal(out.numpy(), ref)
    np.testing.assert_array_equal(out.numpy(), np.take(x, anc, axis=0))


def _field(maps, origins=None):
    origins = torch.zeros(4, 2, dtype=torch.int32) if origins is None else origins
    return tfield.window_field(
        maps, origins.to(maps.device), 16, np.ones(3, np.float32),
        inv_sat=0.5, free_logit=-0.2, free_penalty=0.6,
    )


def _ism(maps, poses=None, region=(16, 16)):
    poses = torch.zeros(4, 3) if poses is None else poses
    return tupd.update_ism(
        maps, poses.to(maps.device), torch.ones(180, device=maps.device),
        region=region, origin_xy=(0.0, 0.0), resolution=0.1, step=0.01,
        angle_min=-1.5, min_range=0.1, max_range=12.0, l_free=-0.4,
        l_occ=0.85, l_clamp=10.0,
    )


_MAPS = torch.zeros(4, 32, 32)
_ANC = torch.zeros(4, dtype=torch.int32)
BAD_CALLS = {
    "field_dtype": lambda: _field(_MAPS.double()),
    "field_origins_dtype": lambda: _field(_MAPS, torch.zeros(4, 2).long()),
    "field_noncontiguous": lambda: _field(torch.zeros(4, 32, 64)[:, :, ::2]),
    "field_device": lambda: _field(_MAPS.to("meta")),
    "ism_dtype": lambda: _ism(_MAPS.half()),
    "ism_poses_shape": lambda: _ism(_MAPS, torch.zeros(4, 2)),
    "ism_region": lambda: _ism(_MAPS, region=(64, 16)),
    "ism_device": lambda: _ism(_MAPS.to("meta")),
    "gather_anc_dtype": lambda: tgather.gather_rows(_MAPS, _ANC.long()),
    "gather_anc_shape": lambda: tgather.gather_rows(_MAPS, _ANC[:3]),
    "gather_device": lambda: tgather.gather_rows(
        _MAPS.to("meta"), _ANC.to("meta")
    ),
    "stack_shape": lambda: tstack.shift_stack(torch.zeros(3, 8, 9), 3, 3),
    "stack_device": lambda: tstack.shift_stack(_MAPS.to("meta"), 3, 3),
}


@pytest.mark.parametrize("bad", sorted(BAD_CALLS))
def test_pf_kernel_wrappers_reject_bad_input(bad):
    with pytest.raises(ValueError):
        BAD_CALLS[bad]()
