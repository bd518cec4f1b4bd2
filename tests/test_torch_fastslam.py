"""PyTorch port: the particle filter (pf/fastslam.py, run/fastslam_run.py)
against the JAX package's, on the CPU, with JAX's random draws injected
(its split(rng, 3) chain replayed here: the proposal noise and the
resample's u).

Config: a 224^2 map at 0.1 m, a 120-beam 8 m sensor, P = 8 float32 maps,
the ISM map update ("pallas") and the shared refine, on 48 scans of a
synthetic log.

- Step parity: every scan, the JAX state goes through the JAX step
  (jitted) and through the port's step. Single steps agree to the refine's
  tolerances (tests/test_torch_shared_refine.py): poses 2e-4, scores
  5e-5, log-weights 30x that on two particles (3e-3), and at most 0.05% of
  map cells differ, each by one l_free or l_occ (the update's contract).
- Run parity: the whole run is not bit-reproducible even within JAX (its
  chunked driver and a loop of its jitted step differ by ~0.1 m on this
  log): the filter amplifies last-bit differences, through the map
  updates and resampling (here the two runs resample once and twice). So
  the run is held to the same gates, a resample wherever its own N_eff
  fell below the threshold (at least once), a trajectory within 0.25 m of
  JAX's, an ATE within 0.03 m of JAX's, and an ATE below odometry's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam2d_tpu.config import PFConfig
from slam2d_tpu.metrics import ate_rmse
from slam2d_tpu.pf import fastslam as jfs
from slam2d_tpu.run.fastslam_run import run_fastslam as jax_run_fastslam
from slam2d_tpu_torch.pf import fastslam as tfs
from slam2d_tpu_torch.run.fastslam_run import run_fastslam
from torch_parity import PF_CFG as CFG
from torch_parity import PF_P as P
from torch_parity import PF_SENSOR as SENSOR
from torch_parity import PF_T as T
from torch_parity import pf_draws, pf_log, to_port

torch.set_num_threads(1)

TCFG = to_port(CFG)
STEP_SCANS = 24  # step parity: bootstrap, 8 refines, resamples
PF = PFConfig(
    n_particles=P, refine_mode="shared", noise_xy=0.02, noise_theta=0.01,
)
POSE_TOL, SCORE_TOL = 2e-4, 5e-5
LOGW_TOL = 2 * PF.weight_sharpness * SCORE_TOL
CPU = torch.device("cpu")


def _reset_counts():
    for name in ("host_syncs", "refines", "updates", "resamples"):
        setattr(tfs.fastslam_step, name, 0)


def _assert_maps_close(out, ref):
    diff = np.abs(np.asarray(out, np.float32) - np.asarray(ref, np.float32))
    assert (diff != 0).mean() <= 0.0005
    off = diff[diff != 0]
    assert (
        np.isclose(off, -CFG.grid.l_free, atol=1e-5)
        | np.isclose(off, CFG.grid.l_occ, atol=1e-5)
    ).all(), off


def test_fastslam_step_matches_jax_from_its_states():
    pf = dataclasses.replace(PF, resample_threshold=0.9)
    log = pf_log()
    odom = log["odom"].astype(np.float32)
    ranges = log["ranges"].astype(np.float32)
    flags = tfs.host_gate_flags(odom, TCFG, odom[0], 0.0, np.inf, 0.0)
    state = jfs.fastslam_init(
        CFG, pf, jax.random.PRNGKey(0), start_pose=odom[0]
    )._replace(prev_odom=jnp.asarray(odom[0]))
    jstep = jax.jit(jfs.fastslam_step, static_argnums=(3, 4))
    _reset_counts()
    for t in range(STEP_SCANS):
        noise, u = pf_draws(state.rng, 1)
        ts = tfs.pf_state_from_numpy(state, CPU)
        state, (ref_bp, ref_ne, ref_sc) = jstep(
            state, jnp.asarray(odom[t]), jnp.asarray(ranges[t]), CFG, pf
        )
        syncs = tfs.fastslam_step.host_syncs
        out, (bp, ne, sc) = tfs.fastslam_step(
            ts, torch.from_numpy(odom[t]), torch.from_numpy(ranges[t]), TCFG,
            to_port(pf), gates=flags[t], noise=torch.from_numpy(noise[0]),
            u=torch.tensor(u[0]),
        )
        # no read for the host's gates; the resample trigger on a refine
        assert tfs.fastslam_step.host_syncs - syncs == int(flags[t, 0])
        out = tfs.pf_state_to_numpy(out)
        np.testing.assert_allclose(
            out.poses, np.asarray(state.poses), atol=POSE_TOL, rtol=0
        )
        np.testing.assert_allclose(
            out.log_w, np.asarray(state.log_w), atol=LOGW_TOL, rtol=0
        )
        np.testing.assert_allclose(
            bp.numpy(), np.asarray(ref_bp), atol=POSE_TOL, rtol=0
        )
        assert abs(float(sc) - float(ref_sc)) <= SCORE_TOL
        assert abs(float(ne) - float(ref_ne)) <= 1e-3
        for f in ("prev_odom", "dist", "since_update", "since_match"):
            np.testing.assert_allclose(
                getattr(out, f), np.asarray(getattr(state, f)), atol=1e-6,
                rtol=0,
            )
        _assert_maps_close(out.logodds, state.logodds)
    assert tfs.fastslam_step.refines == flags[:STEP_SCANS, 0].sum() >= 6
    assert tfs.fastslam_step.updates == flags[:STEP_SCANS, 1].sum()
    assert tfs.fastslam_step.resamples >= 1


def test_run_fastslam_matches_jax():
    log = pf_log()
    _, ref_traj, ref_neff, ref_scores = jax_run_fastslam(log, CFG, PF, seed=0)
    draws = pf_draws(jax.random.PRNGKey(0), T)
    _reset_counts()
    state, traj, n_eff, scores = run_fastslam(
        log, TCFG, to_port(PF), CPU, draws=draws
    )
    flags = tfs.host_gate_flags(log["odom"], TCFG, log["odom"][0], 0.0, np.inf)

    # the same gates: a scan refines exactly where the JAX run did
    np.testing.assert_array_equal(scores != -1.0, flags[:, 0])
    np.testing.assert_array_equal(ref_scores != -1.0, flags[:, 0])
    assert tfs.fastslam_step.refines == flags[:, 0].sum()
    assert tfs.fastslam_step.updates == flags[:, 1].sum()
    # no host read for the gates; one per refine (the resample trigger)
    assert tfs.fastslam_step.host_syncs == tfs.fastslam_step.refines
    # a resample on every refine whose N_eff fell below the threshold, and
    # at least one in each run
    triggered = (n_eff < PF.resample_threshold * P) & flags[:, 0]
    assert tfs.fastslam_step.resamples == triggered.sum() >= 1
    assert ((ref_neff < PF.resample_threshold * P) & flags[:, 0]).any()

    assert np.isfinite(traj).all() and np.isfinite(n_eff).all()
    assert np.abs(traj - ref_traj).max() <= 0.25
    ate = ate_rmse(traj, log["gt_poses"], align=False)
    ref_ate = ate_rmse(ref_traj, log["gt_poses"], align=False)
    ate_odom = ate_rmse(log["odom"], log["gt_poses"], align=False)
    print(f"ATE port {ate:.4f}, JAX {ref_ate:.4f}, odometry {ate_odom:.4f}")
    assert abs(ate - ref_ate) <= 0.03 and ate < ate_odom
    assert state.logodds.shape == (P, 224, 224)
    assert state.logodds.dtype == torch.float32


def test_run_fastslam_resumes_a_split_run():
    """The first STEP_SCANS scans run whole, and split in two with the
    second part resumed from the first part's final state, give the same
    trajectory and N_eff with the same draws; the resume reads the state's
    gate accumulators back once."""
    log = {k: v[:STEP_SCANS] for k, v in pf_log().items()}
    noise, u = pf_draws(jax.random.PRNGKey(0), STEP_SCANS)
    _, traj, n_eff, _ = run_fastslam(log, TCFG, to_port(PF), CPU,
                                     draws=(noise, u))
    cut = STEP_SCANS // 2 + 2
    parts = [slice(0, cut), slice(cut, STEP_SCANS)]
    state, trajs, n_effs = None, [], []
    for part in parts:
        _reset_counts()
        state, tr, ne, _ = run_fastslam(
            {k: v[part] for k, v in log.items()}, TCFG, to_port(PF), CPU,
            state=state,
            draws=(noise[part], u[part]),
        )
        trajs.append(tr)
        n_effs.append(ne)
    step = tfs.fastslam_step
    assert step.refines >= 2 and step.host_syncs == 1 + step.refines
    np.testing.assert_array_equal(np.concatenate(trajs), traj)
    np.testing.assert_array_equal(np.concatenate(n_effs), n_eff)


def test_host_gate_flags_match_jax():
    log = pf_log()
    odom = log["odom"].astype(np.float32)
    for args in ((odom[0], 0.0, np.inf, 0.0), (odom[0], 2.5, 0.1, 0.07)):
        np.testing.assert_array_equal(
            tfs.host_gate_flags(odom, TCFG, *args),
            jfs.host_gate_flags(odom, CFG, *args),
        )
    flags = tfs.host_gate_flags(odom, TCFG, odom[0], 0.0, np.inf, 0.0)
    assert flags[:, 0].any() and flags[:, 1].any() and flags[:, 2].any()


def test_resample_helpers_match_jax():
    rng = np.random.default_rng(5)
    for n in (8, 100):
        log_w = (rng.normal(size=n) * 3).astype(np.float32)
        ref = float(jax.jit(jfs.effective_sample_size)(jnp.asarray(log_w)))
        out = float(tfs.effective_sample_size(torch.from_numpy(log_w)))
        assert abs(out - ref) <= 1e-5 * ref
        for u in (0.0, 0.37, 0.999):
            u = np.float32(u)
            ref = jax.jit(jfs.systematic_ancestors)(
                jnp.asarray(log_w), jnp.asarray(u)
            )
            out = tfs.systematic_ancestors(
                torch.from_numpy(log_w), torch.tensor(u)
            )
            assert out.dtype == torch.int32
            np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("map_dtype", ["float32", "bfloat16"])
def test_init_and_state_round_trip(map_dtype):
    pf = dataclasses.replace(PF, map_dtype=map_dtype)
    start = np.array([1.0, 2.0, 0.5], np.float32)
    ref = jfs.fastslam_init(CFG, pf, jax.random.PRNGKey(0), start_pose=start)
    out = tfs.pf_state_to_numpy(
        tfs.fastslam_init(TCFG, to_port(pf), CPU, start)
    )
    for f in tfs.PFState._fields:
        a, b = getattr(out, f), np.asarray(getattr(ref, f))
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a.astype(np.float32), b.astype(np.float32))
    # arbitrary bf16 maps cross from JAX and back bit for bit
    maps = jax.random.normal(jax.random.PRNGKey(1), (P, 224, 224)) * 4
    ref = ref._replace(logodds=maps.astype(jnp.dtype(map_dtype)))
    back = tfs.pf_state_to_numpy(tfs.pf_state_from_numpy(ref, CPU))
    np.testing.assert_array_equal(
        back.logodds.view(np.uint8), np.asarray(ref.logodds).view(np.uint8)
    )


@pytest.mark.parametrize(
    "pf,why",
    [
        (PFConfig(n_particles=P, refine_mode="shared",
                  update_mode="quantized_per_particle"), "diagnostic"),
        (PFConfig(n_particles=P, refine_mode="shared",
                  update_mode="quantized_xy_only"), "diagnostic, one axis"),
        (PFConfig(n_particles=P, refine_mode="shared", update_mode="shared",
                  update_subcell=2), "shared update: sub-cell images"),
        (PFConfig(n_particles=P, refine_mode="shared", update_mode="shared",
                  update_exact_endpoints=False), "shared update: no marks"),
        (PFConfig(n_particles=P, refine_mode="per_particle",
                  refine_score_impl="mxu"), "a TPU scorer workaround"),
    ],
)
def test_unported_pf_paths_raise(pf, why):
    cfg = dataclasses.replace(
        CFG, grid=dataclasses.replace(CFG.grid, height=32, width=32)
    )
    cfg, pf = to_port(cfg), to_port(pf)
    state = tfs.fastslam_init(cfg, pf, CPU)
    refine = pf.refine_score_impl is not None
    with pytest.raises(NotImplementedError):
        tfs.fastslam_step(
            state, torch.zeros(3), torch.ones(SENSOR.n_beams), cfg, pf,
            gates=(refine, not refine, False),
            noise=torch.zeros(pf.n_particles, 3),
        )
