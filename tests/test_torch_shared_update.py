"""PyTorch port: the shared-anchor map update (pf/shared_update.py) and its
apply kernel (kernel 8, ops/apply.py) against the JAX package's, on the
CPU (its Pallas kernels in interpret mode).

Tolerances:
- apply against shared_apply_update(interpret=True), with fused endpoint
  marks and without: bit-exact, on float32 and on bfloat16 maps (the
  same float32 sums, the same casts, the same map-dtype add and clip).
- shared_update against JAX's: the carve images come from the ISM update
  (the TPU kernel's bits: its bearing and cell centre as XLA compiles
  them), the endpoint cells from cos/sin, which differ from XLA's in the
  last bit. So at most 0.05% of map cells differ, each by one l_free, one
  bf16(l_occ) or their sum (in float32 within 1e-5); at bench_pf.py's
  shapes, about three poses of its log, none.
- A short FastSLAM run with the shared update and the shared refine: ATE
  within 0.03 m of JAX's (the filter amplifies last-bit differences).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam2d_tpu.config import FrontendConfig, GridConfig, PFConfig, SensorConfig
from slam2d_tpu.metrics import ate_rmse
from slam2d_tpu.ops.pallas_apply import (
    shared_apply_supported,
    shared_apply_update,
)
from slam2d_tpu.pf.shared_update import shared_update as jax_shared_update
from slam2d_tpu_torch.ops import apply as tapply
from slam2d_tpu_torch.pf import fastslam as tfs
from slam2d_tpu_torch.pf import shared_update as tsu
from torch_parity import pf_log, pf_run_pair, to_port

import chip_smoke

torch.set_num_threads(1)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
L_CLAMP = 10.0
BF16_OCC = float(np.float32(jnp.bfloat16(0.85)))    # 0.8515625
SHORT_RUN = 32   # scans of the parity log: a multiple of its chunk, 8


def _apply_inputs(jdtype, seed=0):
    """Maps [6, 128, 256] near the clamp, 4 images of 48^2, anchors whose
    images run off every edge, and endpoint marks (repeated cells, zero
    and non-l_occ weights) inside each clamped window."""
    rng = np.random.default_rng(seed)
    P, H, W, win, G, B = 6, 128, 256, 48, 4, 180
    maps = rng.uniform(-9.7, 9.7, (P, H, W)).astype(np.float32)
    images = rng.uniform(-2.0, 2.0, (G, win, win)).astype(np.float32)
    anchors = np.array(
        [[5, 100], [125, 60], [60, 3], [70, 252], [0, 0], [64, 128]],
        np.int32,
    )
    slots = np.array([0, 1, 2, 3, 1, 0], np.int32)
    r0 = np.clip(anchors[:, 0] - win // 2, 0, H - win)
    c0 = np.clip(anchors[:, 1] - win // 2, 0, W - win)
    ep_r = (r0[:, None] + rng.integers(0, win, (P, B))).astype(np.int32)
    ep_c = (c0[:, None] + rng.integers(0, win, (P, B))).astype(np.int32)
    ep_r[:, 40:60] = ep_r[:, 20:40]                  # cells hit twice
    ep_c[:, 40:60] = ep_c[:, 20:40]
    ep_w = np.full((P, B), 0.85, np.float32)
    ep_w[:, ::7] = 0.0
    ep_w[:, 3::11] = 0.3
    jm = jnp.asarray(maps).astype(jdtype)
    return dict(
        maps=jm, images=jnp.asarray(images), anchors=anchors, slots=slots,
        ep=(ep_r, ep_c, ep_w), win=win,
    )


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_matches_pallas_bit_exact(dtype, fused):
    jdtype, tdtype = DTYPES[dtype]
    a = _apply_inputs(jdtype)
    P, H, W = a["maps"].shape
    assert shared_apply_supported(H, W, a["win"], n_images=4,
                                  map_bytes=jnp.dtype(jdtype).itemsize,
                                  bilinear=False, ep_beams=256)
    tm = torch.from_numpy(np.array(a["maps"].astype(jnp.float32))).to(tdtype)
    before = tm.float().numpy().copy()
    ep_kw, tep = {}, {}
    if fused:
        pad = ((0, 0), (0, 256 - 180))
        ep_r, ep_c, ep_w = a["ep"]
        ep_kw = dict(ep_rows=jnp.asarray(np.pad(ep_r, pad)),
                     ep_cols=jnp.asarray(np.pad(ep_c, pad)),
                     ep_w=jnp.asarray(np.pad(ep_w, pad)))
        tep = dict(ep_rows=torch.from_numpy(ep_r), ep_cols=torch.from_numpy(ep_c),
                   ep_w=torch.from_numpy(ep_w))
    ref = np.asarray(shared_apply_update(
        jnp.array(a["maps"]), jnp.asarray(a["anchors"]),
        jnp.asarray(a["slots"]), a["images"], a["win"], L_CLAMP,
        interpret=True, **ep_kw,
    ).astype(jnp.float32))
    out = tapply.shared_apply(
        tm, torch.from_numpy(a["anchors"]), torch.from_numpy(a["slots"]),
        torch.from_numpy(np.array(a["images"])), L_CLAMP, **tep,
    )
    assert out is tm and out.dtype == tdtype            # in place
    out = out.float().numpy()
    np.testing.assert_array_equal(out, ref)
    assert (np.abs(out) == L_CLAMP).sum() > 100          # the clip binds
    # cells outside every image keep their value; every image cell moves
    assert (out[:, 100:, 150:200] == before[:, 100:, 150:200]).all()
    assert (out != before).sum() > 0.5 * 6 * 24 * 24


@pytest.mark.parametrize("img_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("map_dtype", ["float32", "bfloat16"])
def test_apply_band_split_matches_pallas(map_dtype, img_dtype):
    """The apply kernel splits each window into bands of rows, each band
    owning the marks on its rows; its plain version on chip_smoke.py's
    edge operands (anchors near every edge and off the map, marks on
    window rows the image leaves uncovered, one cell hit by non-adjacent
    beams, zero-weight beams on live beams' cells, a 48-row window) is
    bit-exact to the TPU kernel in interpret mode, for maps and images in
    float32 and bfloat16."""
    a = chip_smoke.apply_edge_operands(0)
    jm, tm_dt = DTYPES[map_dtype]
    ji, ti_dt = DTYPES[img_dtype]
    P, H, W = a["maps"].shape
    win = a["win"]
    assert shared_apply_supported(H, W, win, n_images=4,
                                  map_bytes=jnp.dtype(jm).itemsize,
                                  bilinear=False, ep_beams=256)
    maps = jnp.asarray(a["maps"]).astype(jm)
    images = jnp.asarray(a["images"]).astype(ji)
    ep_r, ep_c, ep_w = a["ep"]
    pad = ((0, 0), (0, 256 - ep_r.shape[1]))
    ref = np.asarray(shared_apply_update(
        maps, jnp.asarray(a["anchors"]), jnp.asarray(a["slots"]), images,
        win, L_CLAMP, interpret=True, ep_rows=jnp.asarray(np.pad(ep_r, pad)),
        ep_cols=jnp.asarray(np.pad(ep_c, pad)),
        ep_w=jnp.asarray(np.pad(ep_w, pad)),
    ).astype(jnp.float32))
    tm = torch.from_numpy(a["maps"]).to(tm_dt)
    before = tm.float().numpy().copy()
    out = tapply.shared_apply(
        tm, torch.from_numpy(a["anchors"]), torch.from_numpy(a["slots"]),
        torch.from_numpy(a["images"]).to(ti_dt), L_CLAMP,
        torch.from_numpy(ep_r), torch.from_numpy(ep_c),
        torch.from_numpy(ep_w),
    ).float().numpy()
    np.testing.assert_array_equal(out, ref)
    # the marks on uncovered rows landed: particle 0's image covers rows
    # 0-33 of its window's 0-47
    r, c, w = ep_r[0, 60:80], ep_c[0, 60:80], ep_w[0, 60:80]
    live = (w != 0) & (r >= 34)
    assert live.any()
    assert (out[0, r[live], c[live]] != before[0, r[live], c[live]]).all()
    # beams 5, 100 and 170 mark one cell, live; beam 2 (w = 0) marks
    # live beam 120's cell before it
    for b in (100, 170):
        assert (ep_r[:, b] == ep_r[:, 5]).all() and (ep_c[:, b] == ep_c[:, 5]).all()
    assert (ep_w[:, [5, 100, 170, 120]] != 0).all() and (ep_w[:, 2] == 0).all()


def _cfg(size=256, max_range=4.0):
    """A 256^2 map and a 4 m sensor: a 96^2 update window, which the JAX
    package's Pallas apply takes (shared_apply_supported)."""
    return FrontendConfig(
        sensor=SensorConfig(n_beams=120, max_range=max_range),
        grid=GridConfig(height=size, width=size, resolution=0.1,
                        center_x=8.0, center_y=8.0, update_impl="pallas"),
    )


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_shared_update_matches_jax(dtype):
    jdtype, tdtype = DTYPES[dtype]
    cfg = _cfg()
    P = 8
    pf = PFConfig(n_particles=P, update_mode="shared")
    rng = np.random.default_rng(2)
    log = pf_log()
    poses = log["gt_poses"][20] + np.concatenate(
        [rng.normal(0, 0.2, (P, 2)), rng.normal(0, 0.05, (P, 1))], axis=1
    )
    poses[-2, :2] = (-4.0, 3.0)           # an image that runs off the map
    poses[-1, :2] = (20.0, 20.2)          # and one off the far corner
    poses = poses.astype(np.float32)
    ranges = log["ranges"][20].copy()
    ranges[::13] = np.inf
    maps = rng.uniform(-3, 3, (P, 256, 256)).astype(np.float32)
    jm = jnp.asarray(maps).astype(jdtype)
    assert shared_apply_supported(256, 256, 96, n_images=16,
                                  map_bytes=jnp.dtype(jdtype).itemsize,
                                  bilinear=False, ep_beams=128)
    ref = np.asarray(jax.jit(jax_shared_update, static_argnums=(3, 4))(
        jm, jnp.asarray(poses), jnp.asarray(ranges), cfg, pf,
    ).astype(jnp.float32))
    tm = torch.from_numpy(np.array(jm.astype(jnp.float32))).to(tdtype)
    before = tm.float().numpy().copy()
    out = tfs._update_all(
        tm, torch.from_numpy(poses), torch.from_numpy(ranges), to_port(cfg),
        to_port(pf),
    )
    assert out is tm
    out = out.float().numpy()
    diff = np.abs(out - ref)
    off = diff[diff != 0]
    print(f"cells differing: {off.size} of {diff.size}")
    assert off.size <= 0.0005 * diff.size
    atol = 1e-5 if dtype == "float32" else 0.07        # bf16 ulp at |l| <= 10
    steps = (0.4, BF16_OCC, BF16_OCC - 0.4)
    assert np.any([np.isclose(off, s, atol=atol) for s in steps], axis=0).all()
    changed = (out != before).sum(axis=(1, 2))
    assert (changed[:-2] > 500).all() and (changed[-2:] > 100).all()


@pytest.mark.parametrize("scan", [200, 400, 600])
def test_shared_update_matches_jax_at_bench_shapes(scan):
    """bench_pf.py's shapes: bf16 512^2 maps at 0.1 m, 180 beams to 12 m
    (a 256^2 update window), 16 theta slots, 8 particles about the pose
    at one scan of its log, the ISM carve ("pallas"): every cell the JAX
    package's (0, 8 and 2 cells were one bf16 l_free off while the carve
    took torch.atan2's bearing)."""
    from slam2d_tpu_torch.run.bench_configs import (
        pf_bench_config,
        pf_bench_log,
    )
    from torch_parity import to_jax

    pcfg, _ = pf_bench_config()
    pcfg = dataclasses.replace(
        pcfg, grid=dataclasses.replace(pcfg.grid, update_impl="pallas"))
    cfg = to_jax(pcfg)
    P = 8
    pf = PFConfig(n_particles=P, map_dtype="bfloat16", update_mode="shared")
    assert pf.update_theta_slots == 16
    log = pf_bench_log(pcfg.sensor)
    rng = np.random.default_rng(scan)
    poses = (log["gt_poses"][scan] + np.concatenate(
        [rng.normal(0, 0.2, (P, 2)), rng.normal(0, 0.05, (P, 1))], axis=1
    )).astype(np.float32)
    ranges = log["ranges"][scan]
    maps = rng.uniform(-3, 3, (P, 512, 512)).astype(np.float32)
    jm = jnp.asarray(maps).astype(jnp.bfloat16)
    ref = np.asarray(jax.jit(jax_shared_update, static_argnums=(3, 4))(
        jm, jnp.asarray(poses), jnp.asarray(ranges), cfg, pf,
    ).astype(jnp.float32))
    tm = torch.from_numpy(np.array(jm.astype(jnp.float32))).to(
        torch.bfloat16)
    out = tfs._update_all(tm, torch.from_numpy(poses),
                          torch.from_numpy(ranges), pcfg, to_port(pf))
    out = out.float().numpy()
    diff = np.abs(out - ref)
    off = diff[diff != 0]
    print(f"scan {scan}: {off.size} of {diff.size} cells differ, by "
          f"{sorted(set(off.tolist()))}")
    assert off.size == 0
    assert (out != maps).sum() > P * 10000            # the scan landed


def test_slot_grid_matches_jax():
    from slam2d_tpu.pf.shared_update import quantize_update_poses

    cfg = _cfg()
    rng = np.random.default_rng(5)
    for spread in (0.01, 0.6):
        pf = PFConfig(n_particles=10)
        poses = np.concatenate(
            [rng.uniform(2, 14, (10, 2)), 3.0 + rng.normal(0, spread, (10, 1))],
            axis=1,
        ).astype(np.float32)
        q = np.asarray(jax.jit(quantize_update_poses, static_argnums=(1, 2))(
            jnp.asarray(poses), cfg, pf
        ))
        slot, slot_theta = tsu.slot_grid(
            torch.from_numpy(poses), to_port(cfg), to_port(pf)
        )
        # JAX's quantized heading is slot_theta[slot]
        np.testing.assert_allclose(
            slot_theta[slot].numpy(), q[:, 2], rtol=0, atol=2e-6
        )


@pytest.mark.parametrize(
    "G,win,images_f32,want",
    [(16, 256, False, torch.float32),      # 4,194,304 bytes: exactly 4 MiB
     (16, 264, False, torch.bfloat16),     # past it
     (16, 264, True, torch.float32),       # update_images_f32
     (120, 96, False, torch.bfloat16)],    # many slots, small images
)
def test_image_dtype_rule(monkeypatch, G, win, images_f32, want):
    """shared_update stores its images as bf16 exactly when their float32
    bytes exceed 4 MiB (pf/shared_update.py:259-261), unless
    update_images_f32; the images reach the apply in that dtype."""
    seen = {}

    def fake_images(ranges, slot_theta, cfg, win_, plain=False, gate=None):
        seen["win"] = win_
        return torch.zeros((slot_theta.shape[0], win_, win_))

    def fake_apply(maps, anchors, slots, images, *a, **k):
        seen["dtype"] = images.dtype
        return maps

    monkeypatch.setattr(tsu, "carve_images", fake_images)
    monkeypatch.setattr(tsu, "shared_apply", fake_apply)
    # a map and range whose update window is `win`
    cfg = to_port(_cfg(size=win, max_range=(win / 2 - 8) * 0.1))
    pf = to_port(PFConfig(n_particles=2, update_theta_slots=G,
                          update_images_f32=images_f32))
    tsu.shared_update(torch.zeros(2, win, win), torch.zeros(2, 3),
                      torch.ones(120), cfg, pf)
    assert seen["win"] == win and seen["dtype"] == want
    assert (G * win * win * 4 > 4 * 2**20 and not images_f32) == (
        want == torch.bfloat16
    )


def test_update_mode_auto_is_shared_from_256_particles(monkeypatch):
    calls = []
    monkeypatch.setattr(tfs, "shared_update",
                        lambda *a, **k: calls.append("shared"))
    monkeypatch.setattr(tfs, "update_ism",
                        lambda *a, **k: calls.append("per_particle"))
    cfg = to_port(_cfg(size=64))
    for P in (255, 256):
        tfs._update_all(torch.zeros(P, 64, 64), torch.zeros(P, 3),
                        torch.ones(120), cfg, to_port(PFConfig(n_particles=P)))
    assert calls == ["per_particle", "shared"]


def test_run_fastslam_shared_update_matches_jax():
    """The parity log's config (a 224^2 map, whose width the JAX package's
    Pallas apply does not take: it runs its XLA apply there, with the
    same marks up to float32 rounding)."""
    pf = PFConfig(n_particles=8, refine_mode="shared", update_mode="shared",
                  noise_xy=0.02, noise_theta=0.01)
    log = {k: v[:SHORT_RUN] for k, v in pf_log().items()}
    (ref_traj, _, ref_scores), (traj, n_eff, scores), state = pf_run_pair(
        pf, log=log
    )
    np.testing.assert_array_equal(scores != -1.0, ref_scores != -1.0)
    assert np.isfinite(traj).all() and np.isfinite(n_eff).all()
    assert state.logodds.dtype == torch.float32
    ate = ate_rmse(traj, log["gt_poses"], align=False)
    ref_ate = ate_rmse(ref_traj, log["gt_poses"], align=False)
    ate_odom = ate_rmse(log["odom"], log["gt_poses"], align=False)
    print(f"ATE port {ate:.4f}, JAX {ref_ate:.4f}, odometry {ate_odom:.4f}")
    assert abs(ate - ref_ate) <= 0.03


_M = torch.zeros(2, 32, 32)
_A = torch.zeros(2, 2, dtype=torch.int32)
_S = torch.zeros(2, dtype=torch.int32)
_I = torch.zeros(1, 8, 8)
BAD_APPLY = {
    "maps_dtype": lambda: tapply.shared_apply(_M.half(), _A, _S, _I, 10.0),
    "anchors_dtype": lambda: tapply.shared_apply(_M, _A.long(), _S, _I, 10.0),
    "images_shape": lambda: tapply.shared_apply(
        _M, _A, _S, torch.zeros(1, 8, 9), 10.0),
    "ep_shape": lambda: tapply.shared_apply(
        _M, _A, _S, _I, 10.0, torch.zeros(2, 5, dtype=torch.int32),
        torch.zeros(2, 4, dtype=torch.int32), torch.zeros(2, 4)),
    "device": lambda: tapply.shared_apply(
        _M.to("meta"), _A.to("meta"), _S.to("meta"), _I.to("meta"), 10.0),
}


@pytest.mark.parametrize("bad", sorted(BAD_APPLY))
def test_apply_wrapper_rejects_bad_input(bad):
    with pytest.raises(ValueError):
        BAD_APPLY[bad]()
