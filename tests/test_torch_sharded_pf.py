"""PyTorch port: FastSLAM with its particles split over the ranks
(slam2d_tpu_torch/pf/sharded.py, run/sharded_run.py) on worlds of 2 and
4 gloo ranks on the CPU (rank bodies in tests/torch_dist.py), the
counterpart of tests/test_sharded_pf.py.

- Step parity: from one state (the port's maps after 12 scans, degenerate
  or spread weights), JAX's make_sharded_step on make_particle_mesh(n)
  and the port's sharded_step with JAX's per-shard draws passed in, on a
  refine scan without a map update that resamples across shards: poses
  within 1e-4, log-weights 3e-3 (the refine's score tolerance times the
  sharpness, tests/test_torch_fastslam.py), the maps after the ring bit
  for bit, the same d_max.
- The bounded ring equals the full gather x[ancestors] for every pattern
  (all local, random, one rank on, the worst case), bit for bit.
- The host-gated run loop equals the ungated one, bit for bit; a world of
  one equals the single-device port's run with the same seed at every
  scan but the resample scans (the sharded step reports the best
  particle before the resample, as JAX's sharded step does).
- A run tracks the synthetic log (ATE < 0.6 m, JAX's bound).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist
from slam2d_tpu.config import (
    FrontendConfig,
    GridConfig,
    MatcherConfig,
    PFConfig,
    SensorConfig,
)
from slam2d_tpu.data.synth import SynthWorld, simulate_log
from slam2d_tpu.metrics import ate_rmse
from slam2d_tpu.parallel.mesh import make_particle_mesh
from slam2d_tpu.pf import fastslam as jfs
from slam2d_tpu.pf import sharded as jsh
from slam2d_tpu_torch.parallel import mesh as pmesh
from slam2d_tpu_torch.pf import fastslam as tfs
from slam2d_tpu_torch.run.fastslam_run import run_fastslam
from torch_parity import to_port

torch.set_num_threads(1)

CPU = torch.device("cpu")
P = 16
WARM = 12          # scans that build the step parity's maps
POSE_TOL = 1e-4
LOGW_TOL = 3e-3
CFG = FrontendConfig(
    sensor=SensorConfig(n_beams=60, max_range=12.0),
    grid=GridConfig(
        height=128, width=128, resolution=0.1, ray_samples=64,
        center_x=6.0, center_y=6.0, update_impl="pallas",
    ),
    matcher=MatcherConfig(search_xy=0.2, search_theta=0.1, n_theta=5),
    chunk=4,
    bootstrap_dist=1.0,
)
PF = PFConfig(n_particles=P, noise_xy=0.02, noise_theta=0.01,
              refine_score_impl="cmx")
PF_STEP = dataclasses.replace(PF, resample_threshold=0.9)
TCFG, TPF = to_port(CFG), to_port(PF)


def _log(wp=((3.0, 3.0), (3.0, 7.0), (6.5, 7.0))):
    world = SynthWorld.box_rooms(12.0)
    return simulate_log(world, np.array(wp), CFG.sensor, step=0.2,
                        odom_noise_xy=0.012, odom_noise_theta=0.006, seed=3)


@functools.cache
def _warm_state():
    log = _log()
    state, *_ = run_fastslam({k: v[:WARM] for k, v in log.items()}, TCFG,
                             TPF, CPU, seed=5)
    return tfs.pf_state_to_numpy(state)._asdict(), log


KINDS = ("winner_last", "spread")


def _scenario(kind: str):
    """(state arrays, odom, ranges): a refine is due, no map update, no
    motion; the weights degenerate on global particle 15 (the last rank)
    or spread."""
    arrays, log = _warm_state()
    arrays = dict(arrays)
    odom = np.asarray(log["odom"][WARM - 1], np.float32)
    if kind == "winner_last":
        log_w = np.full(P, -60.0, np.float32)
        log_w[15] = 0.0
    else:
        log_w = np.random.default_rng(1).normal(0, 1.5, P).astype(np.float32)
    # a mark in each map's corner makes every particle's map its own (the
    # warm state's resamples left copies), so a map names its ancestor
    maps = arrays["logodds"].copy()
    maps[:, 0, :P] = 0.0
    maps[np.arange(P), 0, np.arange(P)] = 3.0
    arrays.update(
        logodds=maps,
        log_w=log_w, prev_odom=odom, dist=np.float32(100.0),
        since_update=np.float32(0.0), since_match=np.float32(100.0),
    )
    return arrays, odom, np.asarray(log["ranges"][WARM], np.float32)


@functools.cache
def _jax_stepper(n):
    mesh = make_particle_mesh(n)
    step = jax.jit(jsh.make_sharded_step(CFG, PF_STEP, mesh,
                                         gates=(True, False, False)))
    return mesh, step


def _jax_step(arrays, odom, ranges, n):
    mesh, step = _jax_stepper(n)
    key = jax.random.PRNGKey(7)
    st = jfs.PFState(
        logodds=jnp.asarray(arrays["logodds"]),
        poses=jnp.asarray(arrays["poses"]),
        log_w=jnp.asarray(arrays["log_w"]),
        prev_odom=jnp.asarray(arrays["prev_odom"]), rng=key,
        dist=jnp.float32(arrays["dist"]),
        since_update=jnp.float32(arrays["since_update"]),
        since_match=jnp.float32(arrays["since_match"]),
    )
    out, (bp, ne, sc) = step(jsh.place_state(st, mesh), jnp.asarray(odom),
                             jnp.asarray(ranges))
    # the step's draws: k_step from one split, each shard's noise folded
    _, k_step = jax.random.split(key)
    Pl = P // n
    noise = np.concatenate([
        np.asarray(jax.random.normal(jax.random.fold_in(k_step, s), (Pl, 3)))
        for s in range(n)
    ])
    u = np.float32(jax.random.uniform(jax.random.fold_in(k_step, 10_000_019)))
    return jax.tree.map(np.asarray, out), np.asarray(bp), float(ne), noise, u


def _patterns(n, Pl):
    Pt = n * Pl
    rng = np.random.default_rng(0)
    patterns = [
        np.arange(Pt), rng.integers(0, Pt, Pt), (np.arange(Pt) + Pl) % Pt,
        np.full(Pt, Pt - 1), np.sort(rng.integers(0, Pt, Pt)),
    ]
    return [p.astype(np.int32) for p in patterns]


RING_PL, RING_N = 3, 64


@pytest.fixture(scope="module", params=[2, 4])
def steps(request):
    """Per world size: JAX's step and the port's on each scenario, and the
    port's ring on each pattern (one spawn)."""
    n = request.param
    refs, scenarios = [], []
    for kind in KINDS:
        arrays, odom, ranges = _scenario(kind)
        ref, ref_bp, ref_ne, noise, u = _jax_step(arrays, odom, ranges, n)
        refs.append((ref, ref_bp, ref_ne))
        scenarios.append((arrays, odom, ranges, (True, False, False), noise,
                          u))
    Pt = n * RING_PL
    maps = np.arange(Pt * RING_N, dtype=np.float32).reshape(Pt, RING_N) + 1.0
    patterns = _patterns(n, RING_PL)
    res = pmesh.spawn(torch_dist.pf_steps, n, "gloo", "cpu", args=(
        TCFG, to_port(PF_STEP), scenarios, maps, patterns))
    return n, refs, [r[0] for r in res], res[0][1], maps, patterns


@pytest.mark.parametrize("k", range(len(KINDS)), ids=KINDS)
def test_step_matches_jax_across_shards(steps, k):
    n, refs, outs, _, _, _ = steps
    ref, ref_bp, ref_ne = refs[k]
    out = outs[0][k]["state"]
    np.testing.assert_allclose(out["poses"], ref.poses, atol=POSE_TOL, rtol=0)
    np.testing.assert_allclose(out["log_w"], ref.log_w, atol=LOGW_TOL, rtol=0)
    np.testing.assert_array_equal(out["logodds"], ref.logodds)
    for rank in outs:
        r = rank[k]
        np.testing.assert_allclose(r["best_pose"], ref_bp, atol=POSE_TOL,
                                   rtol=0)
        assert abs(r["n_eff"] - ref_ne) <= 1e-3 * max(1.0, ref_ne)
        assert r["carry"] == P          # resampled: the weights are uniform
    # the resample drew from other ranks, JAX's ring distance
    anc = _ancestors(ref, _scenario(KINDS[k])[0])
    k_need = (np.arange(P) // (P // n) - anc // (P // n)) % n
    assert outs[0][k]["d_max"] == [int(k_need.max())] and k_need.max() >= 1
    if KINDS[k] == "winner_last":
        # every particle adopts the winner's map and pose, across the ranks
        assert (anc == 15).all()
        assert np.abs(out["poses"][:, :2] - out["poses"][15, :2]).max() < 0.5
    else:
        assert len(set(anc // (P // n))) >= 2


def _ancestors(ref, arrays):
    """Each new particle's ancestor, found from the map it now holds."""
    flat = arrays["logodds"].reshape(P, -1)
    return np.array([
        int(np.flatnonzero((flat == m.reshape(-1)).all(1))[0])
        for m in ref.logodds
    ])


def test_bounded_ring_matches_full_gather(steps):
    n, _, _, ring, maps, patterns = steps
    for anc, got in zip(patterns, ring["outs"]):
        np.testing.assert_array_equal(got, maps[anc])
    need = [int(((np.arange(len(a)) // RING_PL - a // RING_PL) % n).max())
            for a in patterns]
    assert ring["d_max"] == need and need[0] == 0 and need[3] == n - 1


@pytest.fixture(scope="module", params=[2, 4])
def runs(request):
    """Per world size: the run host-gated and ungated, seed 1 (one spawn)."""
    n = request.param
    log = _log()
    return n, log, pmesh.spawn(torch_dist.pf_runs, n, "gloo", "cpu",
                               args=(log, TCFG, TPF, 1))


def test_host_gated_matches_ungated(runs):
    _, _, res = runs
    gated, ungated = res[0]
    for k in ("traj", "n_eff", "scores"):
        np.testing.assert_array_equal(gated[k], ungated[k])
    np.testing.assert_array_equal(gated["state"]["logodds"],
                                  ungated["state"]["logodds"])
    assert gated["resamples"] >= 1


def test_tracks_synthetic_log(runs):
    n, log, res = runs
    traj = res[0][0]["traj"]
    for r in res[1:]:
        np.testing.assert_array_equal(r[0]["traj"], traj)
    assert res[0][0]["local_maps"] == P // n
    assert np.isfinite(traj).all()
    assert ate_rmse(traj, log["gt_poses"], align=False) < 0.6


def test_world_of_one_matches_single_device_run():
    log = _log()
    pf = dataclasses.replace(TPF, resample_threshold=0.9)
    (one,) = pmesh.spawn(torch_dist.pf_run, 1, "gloo", "cpu",
                         args=(log, TCFG, pf, 2))
    tfs.fastslam_step.resamples = 0
    state, traj, n_eff, _ = run_fastslam(log, TCFG, pf, CPU, seed=2)
    assert one["resamples"] == tfs.fastslam_step.resamples >= 1
    diff = np.hypot(*(one["traj"] - traj)[:, :2].T)
    # only the resample scans report another particle
    assert (diff > 1e-5).sum() <= one["resamples"]
    np.testing.assert_allclose(one["state"]["poses"],
                               tfs.pf_state_to_numpy(state).poses, atol=1e-5)
    np.testing.assert_allclose(one["n_eff"], n_eff, rtol=1e-4)
