"""PyTorch port: global relocalization (slam2d_tpu_torch/match/global_loc.py)
and run_localization(recover=True) against the JAX package's (CPU).

Maps are built once by the JAX frontend (tests/test_global_loc.py's and
tests/test_localize.py's) and the same numpy map goes to both packages.
Tolerances:
- `_endpoint_image`: every weight within 1e-4 of JAX's (the splat
  positions carry float32 ulps of ~1000-cell coordinates, and XLA's CPU
  cos/sin are not correctly rounded; measured up to 3.1e-5), the same
  total;
- the sweep, with pad_border True and False: the same coarse cell and
  heading index, score and margin within 1e-4 (measured up to 1e-6; two
  FFT libraries), the refined pose within 1e-3 m and 1e-3 rad (measured
  ~5e-7);
- recovery on the kidnap log: the same event scans and skipped scans,
  event poses within 1e-3, scores within 1e-4, the trajectory's ATE within
  5 mm of JAX's; host reads one a scan run, one a chunk and one a
  relocalization. The same on chip_smoke.py phase 14's kidnap log
  (bench.py's step, sensor, matcher and chunk) over the JAX frontend's
  256^2 map of its world: measured, the same event (scan 319) and ATE to
  5 digits.
"""

import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_global_loc as jgl_test
import test_localize as jloc
from slam2d_tpu.data.synth import SynthWorld, simulate_log, splice_odom
from slam2d_tpu.grid.occupancy import scan_endpoints_local as j_endpoints
from slam2d_tpu.match import global_loc as jgl
from slam2d_tpu.metrics import ate_rmse
from slam2d_tpu.run import frontend as jfe
from slam2d_tpu_torch.grid.occupancy import scan_endpoints_local
from slam2d_tpu_torch.match import global_loc as tgl
from slam2d_tpu_torch.run import frontend as tfe
from slam2d_tpu_torch.run.bench_configs import (
    bench_config,
    kidnap_log,
    localization_log,
)
from torch_parity import pose_error, to_jax, to_port

torch.set_num_threads(1)

CPU = torch.device("cpu")
CFG = jgl_test.CFG
POSES = np.array([[4.0, 5.0, 0.7], [9.0, 7.5, -2.2], [14.0, 4.0, 2.9],
                  [9.0, 7.0, 1.3]], np.float32)


@functools.cache
def _map():
    world, logodds = jgl_test._build_map()
    return world, np.array(logodds)


def _ranges(world, pose, sensor=CFG.sensor):
    return np.asarray(world.raycast(pose, np.asarray(sensor.beam_angles()),
                                    sensor.max_range), np.float32)


@pytest.mark.parametrize("shape", [(512, 512), (300, 428)])
def test_endpoint_image_matches_jax(shape):
    H, W = shape
    world, _ = _map()
    r = _ranges(world, POSES[1])
    r[::7] = CFG.sensor.max_range     # no-hit beams: invalid, weight 0
    r[3] = np.nan
    jpts, jvalid = j_endpoints(jnp.asarray(r), CFG.sensor)
    tpts, tvalid = scan_endpoints_local(torch.from_numpy(r), to_port(CFG.sensor))
    thetas = np.array([-np.pi, -1.2, 0.0, 0.7, 2.9], np.float32)
    img = jax.jit(jgl._endpoint_image, static_argnums=(3, 4, 5))
    out = tgl._endpoint_image(tpts, tvalid, torch.from_numpy(thetas), H, W,
                              CFG.grid.resolution)
    assert out.shape == (len(thetas), H, W)
    for k, th in enumerate(thetas):
        ref = np.asarray(img(jpts, jvalid, jnp.float32(th), H, W,
                             CFG.grid.resolution))
        one = tgl._endpoint_image(tpts, tvalid, torch.tensor(th), H, W,
                                  CFG.grid.resolution)
        assert one.shape == (H, W)
        np.testing.assert_array_equal(one.numpy(), out[k].numpy())
        err = float(np.abs(one.numpy() - ref).max())
        print(f"theta {th}: max |err| {err:.3g}")
        assert err <= 1e-4
        assert abs(float(one.sum()) - float(ref.sum())) <= 1e-3
        assert float(one.sum()) == pytest.approx(float(tvalid.sum()), 1e-5)


@functools.cache
def _jax_localize(i, pad_border, refine):
    world, logodds = _map()
    out = jgl.global_localize(logodds, _ranges(world, POSES[i]), CFG.grid,
                              CFG.matcher, CFG.sensor, refine=refine,
                              return_margin=True, pad_border=pad_border)
    return tuple(np.asarray(x) for x in out)


@pytest.mark.parametrize("pad_border", [True, False])
@pytest.mark.parametrize("i", range(len(POSES)))
def test_global_localize_matches_jax(i, pad_border):
    world, logodds = _map()
    r = _ranges(world, POSES[i])
    cfg = to_port(CFG)
    lo = torch.from_numpy(logodds.copy())
    S = tfe.build_search_space(lo, cfg.matcher, cfg.grid.resolution)
    for refine in (False, True):
        jp, js, jm = _jax_localize(i, pad_border, refine)
        tp, ts, tm = tgl.global_localize(
            lo, torch.from_numpy(r), cfg.grid, cfg.matcher, cfg.sensor,
            refine=refine, return_margin=True, pad_border=pad_border,
            search_space=S)
        tp = tp.numpy()
        print(f"pose {i} pad {pad_border} refine {refine}: port {tp} "
              f"{float(ts):.6f} {float(tm):.6f}, JAX {jp} {float(js):.6f} "
              f"{float(jm):.6f}")
        assert abs(float(ts) - float(js)) <= 1e-4
        assert abs(float(tm) - float(jm)) <= 1e-4
        if refine:
            dxy, dth = pose_error(tp, jp)
            assert dxy <= 1e-3 and dth <= 1e-3
        else:
            assert tgl.sweep_cell(tp, cfg.grid) == tgl.sweep_cell(
                jp, cfg.grid)
    # the search space built inside (no `search_space`) is the same one
    tp2, ts2 = tgl.global_localize(logodds, r, cfg.grid, cfg.matcher,
                                   cfg.sensor, pad_border=pad_border,
                                   device=CPU)
    assert tp2.device == CPU
    np.testing.assert_array_equal(tp2.numpy(), tp)
    assert float(ts2) == float(ts)


def test_global_localize_recovers_the_pose():
    """tests/test_global_loc.py's limits, on the port."""
    world, logodds = _map()
    cfg = to_port(CFG)
    for true in POSES[:3]:
        est, score = tgl.global_localize(
            torch.from_numpy(logodds), torch.from_numpy(_ranges(world, true)),
            cfg.grid, cfg.matcher, cfg.sensor)
        dxy, dth = pose_error(est.numpy(), true)
        assert dxy < 0.15 and dth < 0.1 and float(score) > 0.4


def test_global_localize_rejects_a_ragged_heading_chunk():
    _, logodds = _map()
    cfg = to_port(CFG)
    with pytest.raises(ValueError, match="theta_chunk"):
        tgl.global_localize(logodds, np.ones(120, np.float32), cfg.grid,
                            cfg.matcher, cfg.sensor, n_theta=72,
                            theta_chunk=7, device=CPU)


@functools.cache
def _kidnap():
    """tests/test_localize.py's kidnap log and map (test_recovery_after_
    kidnap), the map built by the JAX frontend."""
    world = SynthWorld.box_rooms(20.0)
    map_log = simulate_log(
        world,
        np.array([[3, 3], [3, 8], [8, 8], [12, 3.5], [16, 3.5],
                  [17, 9], [12, 14], [9, 17], [4, 16]], float),
        jloc.CFG.sensor, step=0.15, odom_noise_xy=0.005,
        odom_noise_theta=0.002, seed=1,
    )
    state, _, _ = jfe.run_frontend(map_log, jloc.CFG)
    a = simulate_log(world, np.array([[3, 3], [3, 8], [7, 8]], float),
                     jloc.CFG.sensor, step=0.15, seed=3)
    b = simulate_log(world,
                     np.array([[16, 3.5], [16.5, 8.5], [12.5, 13.5]], float),
                     jloc.CFG.sensor, step=0.15, seed=4)
    log = {
        "odom": np.concatenate([a["odom"], splice_odom(a["odom"], b["odom"])]),
        "ranges": np.concatenate([a["ranges"], b["ranges"]]),
        "gt_poses": np.concatenate([a["gt_poses"], b["gt_poses"]]),
    }
    return np.array(state.logodds), log


def _assert_recovery_matches_jax(log, jcfg, prebuilt):
    """run_localization(recover=True) of both packages on one map and log:
    the same event scans and skipped scans, event poses within 1e-3,
    scores within 1e-4, ATE within 5 mm. Returns the port's
    (trajectory, scores, events) and its host reads."""
    _, jt, jsc, jev = jfe.run_localization(log, jcfg, prebuilt, recover=True)
    tfe.frontend_step.host_syncs = 0
    ts, tt, tsc, tev = tfe.run_localization(
        log, to_port(jcfg), prebuilt, CPU, recover=True)
    syncs = tfe.frontend_step.host_syncs
    print("events port", tev)
    print("events JAX ", jev)
    assert len(jev) >= 1
    assert [e["scan"] for e in tev] == [e["scan"] for e in jev]
    for a, b in zip(tev, jev):
        assert set(a) == set(b) == {"scan", "score", "margin", "pose"}
        dxy, dth = pose_error(np.array(a["pose"]), np.array(b["pose"]))
        assert dxy <= 1e-3 and dth <= 1e-3
        assert abs(a["score"] - b["score"]) <= 1e-4
    np.testing.assert_array_equal(tsc == -1.0, jsc == -1.0)
    gt = log["gt_poses"]
    ate_t, ate_j = ate_rmse(tt, gt, align=False), ate_rmse(jt, gt, align=False)
    print(f"ATE port {ate_t:.5f} JAX {ate_j:.5f}")
    assert abs(ate_t - ate_j) <= 5e-3
    # the map is untouched
    np.testing.assert_array_equal(ts.logodds.numpy(), prebuilt)
    return tt, tsc, tev, syncs


def test_recovery_matches_jax():
    prebuilt, log = _kidnap()
    tt, tsc, tev, syncs = _assert_recovery_matches_jax(log, jloc.CFG,
                                                       prebuilt)
    gt = log["gt_poses"]
    # tracking is back near ground truth after the last recovery
    k0 = tev[-1]["scan"] + 1
    assert np.median(np.hypot(*(tt[k0:, :2] - gt[k0:, :2]).T)) < 0.5
    # the gates stay on the device, and host_syncs counts reads of CUDA
    # tensors only: on the CPU none (on the card: one score read a chunk
    # and one a relocalization, chip_smoke.py phase 14)
    K = jloc.CFG.chunk
    n_chunks = -(-len(tt) // K)
    attempts = 0
    for c in range(n_chunks):
        sc = tsc[c * K : (c + 1) * K]
        m = sc[sc != -1.0]
        attempts += len(m) >= 3 and float(np.median(m)) < 0.25
    assert syncs == 0
    assert attempts >= len(tev)


def test_recovery_matches_jax_at_bench_step():
    """chip_smoke.py phase 14's kidnap log (run/bench_configs.kidnap_log:
    bench.py's 0.05 m step and sensor, 609 scans) with bench.py's matcher,
    chunk and motion gate, on the JAX frontend's map of the same world
    (tests/test_localize.py's 256^2 grid at 0.1 m): both packages relocalize
    at the same scans."""
    prebuilt, _ = _kidnap()
    jcfg = dataclasses.replace(to_jax(bench_config()), grid=jloc.CFG.grid)
    log = kidnap_log(to_port(jcfg.sensor))
    tt, _, tev, _ = _assert_recovery_matches_jax(log, jcfg, prebuilt)
    gt = log["gt_poses"]
    k0 = tev[-1]["scan"] + 1
    assert np.median(np.hypot(*(tt[k0:, :2] - gt[k0:, :2]).T)) < 0.5


def test_no_recovery_events_on_a_healthy_log():
    """recover=True on a log that never loses track: no event, and the
    same trajectory as recover=False."""
    _, loc_log = jloc._logs()
    prebuilt, _ = _kidnap()
    part = {k: v[:48] for k, v in loc_log.items()}
    cfg = to_port(jloc.CFG)
    _, t0, s0, e0 = tfe.run_localization(part, cfg, prebuilt, CPU)
    _, t1, s1, e1 = tfe.run_localization(part, cfg, prebuilt, CPU,
                                         recover=True)
    assert e0 == e1 == []
    np.testing.assert_array_equal(t0, t1)
    np.testing.assert_array_equal(s0, s1)


def test_recovery_consistency_gate_needs_two_lost_chunks():
    """With recover_consistent, the first lost chunk only records its
    candidate; with it off, the first accepted candidate commits at once
    (an earlier or equal event scan)."""
    prebuilt, log = _kidnap()
    cfg = to_port(jloc.CFG)
    _, _, _, ev = tfe.run_localization(log, cfg, prebuilt, CPU, recover=True)
    _, _, _, ev_fast = tfe.run_localization(
        log, cfg, prebuilt, CPU, recover=True, recover_consistent=False)
    assert ev and ev_fast and ev_fast[0]["scan"] <= ev[0]["scan"]
    _, _, _, jev_fast = jfe.run_localization(
        log, jloc.CFG, prebuilt, recover=True,
        recover_consistent=False)
    assert [e["scan"] for e in ev_fast] == [e["scan"] for e in jev_fast]


def test_relocalization_reference_is_phase_14s_draw():
    """scripts/relocalization_reference.json, the JAX package's results
    that chip_smoke.py phase 14 holds the port to, is made at the scans
    that phase 14 draws from its log, and applies to its own map only."""
    import chip_smoke

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, chip_smoke.RELOC_REFERENCE)) as f:
        ref = json.load(f)
    n = len(localization_log(bench_config().sensor)["odom"])
    assert [r["scan"] for r in ref["global_localize"]] == (
        chip_smoke.global_picks(n).tolist())
    other = np.zeros((4, 4), np.float32)
    assert chip_smoke.relocalization_reference(other) == (
        None, chip_smoke.map_sha256(other))
