"""PyTorch port: the hybrid map update and the occupancy helpers against
the JAX package (CPU; the TPU kernel runs in interpret mode).

The port's hybrid update computes a cell's bearing as the TPU kernel
does under XLA (its polynomial atan2, `core/numerics.py:atan2_ref`, and
the cell centre as one FMA), its endpoints with the framework's cos/sin,
where the TPU kernel uses XLA's cos/sin; the other updates take atan2. A
last-bit difference there moves a cell across a beam slot or an endpoint
across a cell edge, so the contract is: at least 99.95% of cells
bit-identical, and every other cell off by exactly one l_free or one
l_occ. On windows of full SLAM's seed-4 log where atan2 moves a cell
across a slot's edge, the hybrid update is the reference's exactly.
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
