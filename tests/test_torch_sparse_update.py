"""PyTorch port: the sampled-ray, dense and endpoint map updates
(grid/occupancy.py) against the JAX package's, on the CPU.

Inputs are seeded numpy arrays and synthetic box-rooms scans handed to
the jitted JAX function and to the port's. Tolerances:
- `raycast_update` and `endpoint_update`: at most 0.05% of cells off,
  each by at most one l_occ + one l_free (most scenes are bit-identical).
  The port rounds as XLA compiles the JAX package on the CPU (constants
  folded as multiplications by float32 reciprocals, `pose + dir * d`
  contracted into one rounding) and adds the entries in index order (one
  thread: a serial loop, as XLA's scatter), but XLA's CPU cos and sin
  are not correctly rounded: an endpoint or a sample on a cell edge moves
  to the next cell (ROADMAP queue 3's numeric facts).
- `raycast_update_dense`: at most 0.01% of cells off, each by exactly
  one l_free or one l_occ (atan2 and hypot differ from XLA's in the last
  bit, which moves a cell across a beam slot).
- the in-place gated form against extract -> update -> write:
  bit-identical, and a gate of 0 leaves the map's bits.
- `run_frontend` with the sampled-ray update: poses within 5 mm / 5 mrad
  of the JAX package's run (the frontend parity's tolerance).
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam2d_tpu.config import GridConfig, SensorConfig
from slam2d_tpu.grid import occupancy as jocc
from slam2d_tpu.run.frontend import run_frontend as jax_run_frontend
from slam2d_tpu_torch.grid import occupancy as tocc
from slam2d_tpu_torch.run.frontend import run_frontend
from torch_parity import (
    e2e_log,
    frontend_cfg,
    pose_error,
    synth_ranges,
    to_port,
)

torch.set_num_threads(1)

CPU = torch.device("cpu")
GCFG = GridConfig(height=256, width=256, resolution=0.1, ray_samples=128)
BOX = GridConfig(height=256, width=256, resolution=0.1, ray_samples=192,
                 center_x=10.0, center_y=10.0)
BEAM = SensorConfig(n_beams=1, fov_rad=0.0, angle_min=0.0, max_range=8.0)
S180 = SensorConfig(n_beams=180, max_range=8.0)
S270 = SensorConfig(n_beams=1081, fov_rad=1.5 * math.pi,
                    angle_min=-0.75 * math.pi, max_range=12.0)
S360 = SensorConfig(n_beams=360, fov_rad=2 * math.pi * 359 / 360,
                    angle_min=-math.pi, max_range=12.0)
DENSE_CELL_SHARE = 1e-4
SPARSE_CELL_SHARE = 5e-4
POSE_TOL = 5e-3

_jit_sparse = jax.jit(jocc.raycast_update, static_argnames=("cfg", "sensor"))
_jit_dense = jax.jit(jocc.raycast_update_dense,
                     static_argnames=("cfg", "sensor"))
_jit_endpoint = jax.jit(jocc.endpoint_update,
                        static_argnames=("cfg", "sensor", "accumulate"))


def _scene(name: str):
    """(grid [H, W] float32, pose [3], ranges [B], GridConfig,
    SensorConfig, kwargs) of one update scene."""
    rng = np.random.default_rng(3)
    noise = rng.normal(0.0, 2.0, (256, 256)).astype(np.float32)
    if name == "beam":
        return (np.zeros((256, 256), np.float32), np.zeros(3, np.float32),
                np.array([3.0], np.float32), GCFG, BEAM, {})
    if name == "beam_no_hit":
        return (np.zeros((256, 256), np.float32), np.zeros(3, np.float32),
                np.array([8.0], np.float32), GCFG, BEAM, {})
    if name == "out_of_bounds":
        small = GridConfig(height=64, width=64, resolution=0.1,
                           ray_samples=64)
        return (np.zeros((64, 64), np.float32),
                np.array([2.9, 0.0, 0.0], np.float32),
                np.array([6.0], np.float32), small, BEAM, {})
    pose = np.array([6.3, 5.8, 0.4], np.float32)
    sensor = {"box270": S270, "box360": S360}.get(name, S180)
    ranges = synth_ranges(pose, sensor)
    if name == "box_clamped":
        noise = np.clip(noise * 5.0, -BOX.l_clamp, BOX.l_clamp)
    if name == "box_origin_xy":
        return (noise[:96, :112].copy(), pose, ranges, BOX, sensor,
                dict(origin_xy=(3.05, 2.95)))
    if name == "box_origin_rc":
        return (noise[:96, :112].copy(), pose, ranges, BOX, sensor,
                dict(origin_rc=(70, 41)))
    if name == "box_enable0":
        return noise, pose, ranges, BOX, sensor, dict(enable=0.0)
    if name == "box_invalid":
        r = ranges.copy()
        r[::7] = np.nan
        r[3::11] = np.inf
        r[5::13] = 0.05
        return noise, pose, r, BOX, sensor, {}
    return noise, pose, ranges, BOX, sensor, {}


def _jax_kwargs(kw):
    out = dict(kw)
    if "origin_rc" in out:
        out["origin_rc"] = tuple(jnp.int32(v) for v in out["origin_rc"])
    return out


SPARSE_SCENES = ["beam", "beam_no_hit", "out_of_bounds", "box", "box270",
                 "box360", "box_clamped", "box_origin_xy", "box_origin_rc",
                 "box_enable0", "box_invalid"]


def _sparse_close(got, want, gcfg):
    """At most SPARSE_CELL_SHARE of cells off, each by at most one l_occ
    and one l_free (a moved endpoint or sample)."""
    off = got != want
    assert off.mean() <= SPARSE_CELL_SHARE, off.sum()
    if off.any():
        d = np.abs(got[off] - want[off])
        assert d.max() <= gcfg.l_occ + abs(gcfg.l_free) + 1e-5, d.max()


@pytest.mark.parametrize("scene", SPARSE_SCENES)
def test_raycast_update_matches_jax(scene):
    grid, pose, ranges, gcfg, sensor, kw = _scene(scene)
    want = np.asarray(_jit_sparse(jnp.asarray(grid), jnp.asarray(pose),
                                  jnp.asarray(ranges), cfg=gcfg,
                                  sensor=sensor, **_jax_kwargs(kw)))
    got = tocc.raycast_update(torch.from_numpy(grid), torch.from_numpy(pose),
                              torch.from_numpy(ranges), to_port(gcfg),
                              to_port(sensor), **kw).numpy()
    _sparse_close(got, want, gcfg)
    if scene == "beam":   # test_grid.py's marks
        r0, c0 = GCFG.height // 2, GCFG.width // 2
        assert got[r0, c0 + 30] > 0.5 and got[r0, c0 + 5] < 0.0


def test_raycast_update_accumulates_and_clamps():
    """test_grid.py's 40 repeated updates: the same bits as JAX's at every
    step, within the clamp, the endpoint saturating."""
    g_j = jnp.zeros((256, 256), jnp.float32)
    g_t = torch.zeros((256, 256))
    pose = np.zeros(3, np.float32)
    ranges = np.array([3.0], np.float32)
    for _ in range(40):
        g_j = _jit_sparse(g_j, jnp.asarray(pose), jnp.asarray(ranges),
                          cfg=GCFG, sensor=BEAM)
        g_t = tocc.raycast_update(g_t, torch.from_numpy(pose),
                                  torch.from_numpy(ranges), to_port(GCFG),
                                  to_port(BEAM))
    np.testing.assert_array_equal(g_t.numpy(), np.asarray(g_j))
    assert g_t.abs().max() <= GCFG.l_clamp
    assert g_t[128, 158] > 5.0


@pytest.mark.parametrize("scene", ["box", "box_origin_rc", "box_enable0",
                                   "box_invalid", "box270"])
def test_endpoint_update_matches_jax(scene):
    grid, pose, ranges, gcfg, sensor, kw = _scene(scene)
    kw.pop("origin_xy", None)
    want = np.asarray(_jit_endpoint(jnp.asarray(grid), jnp.asarray(pose),
                                    jnp.asarray(ranges), cfg=gcfg,
                                    sensor=sensor, accumulate="scatter",
                                    **_jax_kwargs(kw)))
    got = tocc.endpoint_update(torch.from_numpy(grid), torch.from_numpy(pose),
                               torch.from_numpy(ranges), to_port(gcfg),
                               to_port(sensor), **kw).numpy()
    _sparse_close(got, want, gcfg)


def _dense_close(got, want, gcfg):
    """At most DENSE_CELL_SHARE of cells off, each by one l_free or l_occ."""
    off = got != want
    assert off.mean() <= DENSE_CELL_SHARE, off.sum()
    d = np.abs(got[off] - want[off])
    steps = np.array([abs(gcfg.l_free), gcfg.l_occ,
                      abs(gcfg.l_free) + gcfg.l_occ])
    assert np.all(np.min(np.abs(d[:, None] - steps[None]), axis=1) < 1e-5), d


@pytest.mark.parametrize("scene", ["beam", "beam_no_hit", "box", "box270",
                                   "box360", "box_origin_xy", "box_enable0",
                                   "box_invalid"])
def test_raycast_update_dense_matches_jax(scene):
    grid, pose, ranges, gcfg, sensor, kw = _scene(scene)
    want = np.asarray(_jit_dense(jnp.asarray(grid), jnp.asarray(pose),
                                 jnp.asarray(ranges), cfg=gcfg,
                                 sensor=sensor, **kw))
    got = tocc.raycast_update_dense(
        torch.from_numpy(grid), torch.from_numpy(pose),
        torch.from_numpy(ranges), to_port(gcfg), to_port(sensor),
        **kw).numpy()
    _dense_close(got, want, gcfg)
    if scene == "beam":   # test_dense_update.py's marks
        r0, c0 = GCFG.height // 2, GCFG.width // 2
        assert got[r0, c0 + 30] > 0.5 and got[r0, c0 + 10] < 0.0
        assert got[r0 + 50, c0] == 0.0


def test_dense_covers_the_rear_sector_of_a_wide_scan():
    """A 360-degree scan's bearings past pi land in its field of view: the
    cells behind the pose (relative bearing past 3 pi / 4, within 3 m) are
    carved free, as the JAX package's wrap into [0, 2 pi) from angle_min
    does; a 180-degree scan leaves them unknown. The pose faces the
    nearby wall, with the open room behind it."""
    _, pose, _, gcfg, _, _ = _scene("box360")
    pose = np.array([pose[0], pose[1], pose[2] - math.pi], np.float32)
    H, W = gcfg.height, gcfg.width
    rows, cols = np.mgrid[0:H, 0:W]
    cx = gcfg.origin_x + (cols + 0.5) * gcfg.resolution - pose[0]
    cy = gcfg.origin_y + (rows + 0.5) * gcfg.resolution - pose[1]
    rel = np.angle(np.exp(1j * (np.arctan2(cy, cx) - pose[2])))
    rear = (np.abs(rel) > 0.75 * math.pi) & (np.hypot(cx, cy) < 3.0)
    for sensor, free_share in ((S360, 0.5), (S180, 0.0)):
        out = tocc.raycast_update_dense(
            torch.zeros((H, W)), torch.from_numpy(pose),
            torch.from_numpy(synth_ranges(pose, sensor)), to_port(gcfg),
            to_port(sensor)).numpy()
        if free_share:
            assert (out[rear] < 0.0).mean() > free_share
        else:
            assert not out[rear].any()


WINDOW_ORIGINS = {"inside": (70, 41), "top_left": (0, 0),
                  "bottom_right": (256 - 96, 256 - 112)}


@pytest.mark.parametrize("corner", sorted(WINDOW_ORIGINS))
@pytest.mark.parametrize("impl", ["sparse", "sparse_mxu"])
def test_window_form_matches_extract_update_write(corner, impl):
    """integrate_scan_window in place at a device origin: the window's
    bits of extract -> integrate_scan(origin_rc) -> write; gate 0 leaves
    the map's bits."""
    grid, pose, ranges, gcfg, sensor, _ = _scene("box")
    gcfg = to_port(dataclasses.replace(gcfg, update_impl=impl))
    sensor = to_port(sensor)
    r0, c0 = WINDOW_ORIGINS[corner]
    m0 = torch.from_numpy(grid)
    pose_t, ranges_t = torch.from_numpy(pose), torch.from_numpy(ranges)
    origin = torch.tensor([r0, c0], dtype=torch.int32)
    want = m0.clone()
    want[r0:r0 + 96, c0:c0 + 112] = tocc.integrate_scan(
        m0[r0:r0 + 96, c0:c0 + 112].contiguous(), pose_t, ranges_t, gcfg,
        sensor, origin_rc=(r0, c0))
    for gate, expect in ((True, want), (False, m0)):
        m = m0.clone()
        out = tocc.integrate_scan_window(
            m, pose_t, ranges_t, gcfg, sensor, origin=origin, size=(96, 112),
            gate=torch.tensor(gate))
        assert out is m
        assert torch.equal(m, expect)


def test_window_form_without_origin_is_the_full_grid_update():
    grid, pose, ranges, gcfg, sensor, _ = _scene("box")
    gcfg, sensor = to_port(dataclasses.replace(gcfg, update_impl="sparse")), \
        to_port(sensor)
    m = torch.from_numpy(grid.copy())
    tocc.integrate_scan_window(m, torch.from_numpy(pose),
                               torch.from_numpy(ranges), gcfg, sensor,
                               origin=None, size=(256, 256),
                               gate=torch.tensor(True))
    want = tocc.raycast_update(torch.from_numpy(grid), torch.from_numpy(pose),
                               torch.from_numpy(ranges), gcfg, sensor)
    assert torch.equal(m, want)


NARROW = SensorConfig(n_beams=180, max_range=12.0)
WIDE = SensorConfig(n_beams=271, fov_rad=1.5 * math.pi,
                    angle_min=-0.75 * math.pi, max_range=12.0)


@pytest.mark.parametrize(
    "impl,sensor,ctx,want",
    [
        ("auto", NARROW, "frontend", "pallas_hybrid"),
        ("auto", NARROW, "pf", "pallas"),
        ("auto", WIDE, "frontend", "sparse"),
        ("auto", WIDE, "pf", "sparse"),
        ("sparse", NARROW, "frontend", "sparse"),
        ("sparse", WIDE, "frontend", "sparse"),
        ("sparse_mxu", WIDE, "frontend", "sparse_mxu"),
        ("dense", WIDE, "frontend", "dense"),
        ("dense", NARROW, "pf", "dense"),
        ("pallas", NARROW, "frontend", "pallas"),
        ("pallas_ray", NARROW, "frontend", "pallas_ray"),
        ("pallas_hybrid", NARROW, "pf", "pallas_hybrid"),
    ],
)
def test_resolve_update_impl(impl, sensor, ctx, want):
    gcfg = to_port(dataclasses.replace(GCFG, update_impl=impl))
    assert tocc.resolve_update_impl(gcfg, to_port(sensor), ctx) == want


@pytest.mark.parametrize("impl", ["pallas", "pallas_ray", "pallas_hybrid"])
def test_explicit_kernel_past_pi_raises(impl):
    """The kernels test an unwrapped bearing, so beams past pi never fire;
    the JAX package runs them so (a quirk of the reference), the port
    raises and says where it is recorded."""
    gcfg = to_port(dataclasses.replace(GCFG, update_impl=impl))
    with pytest.raises(NotImplementedError, match="ROADMAP queue 3"):
        tocc.resolve_update_impl(gcfg, to_port(WIDE))


def test_unknown_update_impl_raises():
    gcfg = to_port(dataclasses.replace(GCFG, update_impl="mxu"))
    with pytest.raises(ValueError):
        tocc.resolve_update_impl(gcfg, to_port(NARROW))


@pytest.mark.parametrize("impl", ["sparse", "sparse_mxu", "dense"])
def test_integrate_scan_dispatches(impl):
    grid, pose, ranges, gcfg, sensor, _ = _scene("box")
    pcfg = to_port(dataclasses.replace(gcfg, update_impl=impl))
    args = (torch.from_numpy(grid), torch.from_numpy(pose),
            torch.from_numpy(ranges))
    got = tocc.integrate_scan(*args, pcfg, to_port(sensor),
                              origin_rc=(0, 0))
    fn = tocc.raycast_update_dense if impl == "dense" else tocc.raycast_update
    assert torch.equal(got, fn(*args, pcfg, to_port(sensor)))


def test_run_frontend_sparse_matches_jax():
    """The frontend with the sampled-ray update (the JAX package's CPU
    "auto") over test_frontend_e2e's log at 512^2 (a 288^2 scan window and
    a 272^2 update window) against JAX's run: poses within 5 mm, scores
    within 1e-4."""
    cfg = frontend_cfg(size=512, update_impl="sparse")
    log = e2e_log()
    _, ref_traj, ref_scores = jax_run_frontend(log, cfg)
    _, traj, scores = run_frontend(log, to_port(cfg), device=CPU)
    dxy, dth = pose_error(np.asarray(traj), np.asarray(ref_traj))
    assert dxy <= POSE_TOL and dth <= POSE_TOL, (dxy, dth)
    np.testing.assert_allclose(np.asarray(scores), np.asarray(ref_scores),
                               atol=1e-4)
