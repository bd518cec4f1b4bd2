"""PyTorch port: FastSLAM's device-gated step and driver, the JAX
package's ungated single program (`make_pf_chunk_fn`,
`run_fastslam(host_gated=False)`), on the CPU, with JAX's draws
(torch_parity.pf_draws).

- Run parity: `run_fastslam(host_gated=False)` against JAX's, held as
  tests/test_torch_fastslam.py:test_run_fastslam_matches_jax holds the
  host-gated run (its config, its tolerances: the same refine scans, a
  trajectory within 0.25 m of JAX's, an ATE within 0.03 m of JAX's), at
  16 particles (the per-particle refine, kernel 5's plain version, on a
  log whose length is no multiple of the chunk), 32 (the shared refine)
  and 8 with the shared update (kernel 8's plain version); and equal bit
  for bit to the port's host-gated run with the same draws. At 32
  particles the best particle is another of near-equal weight from the
  first refine on (N_eff 30.65 against JAX's 30.52 there), in the
  host-gated run as in this one, and the per-scan trajectory lies up to
  0.343 m from JAX's: that case is held by its ATE and its refine scans,
  and its trajectory's distance printed.
- Step bits: the device-gated step with every gated stage run (as on
  CUDA, `host_branch=False`) gives the host-bool step's bits at every
  scan, for each update the particle filter runs.
- `host_gated=None` resolves as the JAX package's rule.
- Each gated plain version leaves its output bit-identical at gate 0 and
  equals the ungated call at gate 1.
The CUDA graph itself runs only on the card (chip_smoke.py phase 23).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from slam2d_tpu.config import FrontendConfig, GridConfig, PFConfig
from slam2d_tpu.metrics import ate_rmse
from slam2d_tpu.run import fastslam_run as jfr
from slam2d_tpu_torch.grid import occupancy as tocc
from slam2d_tpu_torch.ops import apply as tapply
from slam2d_tpu_torch.ops import corr as tcorr
from slam2d_tpu_torch.ops import field as tfield
from slam2d_tpu_torch.ops import gather as tgather
from slam2d_tpu_torch.ops import stack as tstack
from slam2d_tpu_torch.ops import update as tupd
from slam2d_tpu_torch.pf import fastslam as tfs
from slam2d_tpu_torch.run import fastslam_run as tfr
from torch_parity import PF_CFG as CFG
from torch_parity import PF_SENSOR, pf_draws, pf_log, to_port

torch.set_num_threads(1)

CPU = torch.device("cpu")
NOISE = dict(noise_xy=0.02, noise_theta=0.01)
RUNS = {
    # (PFConfig, scans): 44 is no multiple of CFG.chunk (8)
    "per_particle_16": (PFConfig(n_particles=16, refine_score_impl="cmx",
                                 **NOISE), 44),
    "shared_refine_32": (PFConfig(n_particles=32, **NOISE), 48),
    "shared_update_8": (PFConfig(n_particles=8, refine_mode="shared",
                                 update_mode="shared", **NOISE), 48),
}
TRAJ_HELD = ("per_particle_16", "shared_update_8")   # see the docstring
STEP_SCANS = 24     # bootstrap, 8 refines, resamples at threshold 0.9
STEP_P = 4


def _reset_counts():
    for name in ("host_syncs", "refines", "updates", "resamples"):
        setattr(tfs.fastslam_step, name, 0)


@pytest.mark.parametrize("case", list(RUNS))
def test_ungated_run_matches_jax(case):
    pf, n = RUNS[case]
    log = {k: v[:n] for k, v in pf_log().items()}
    P = pf.n_particles
    _, ref_traj, _, ref_scores = jfr.run_fastslam(log, CFG, pf, seed=0,
                                                  host_gated=False)
    draws = pf_draws(jax.random.PRNGKey(0), n, P)
    _reset_counts()
    state, traj, n_eff, scores = tfr.run_fastslam(
        log, to_port(CFG), to_port(pf), CPU, draws=draws, host_gated=False)
    assert traj.shape == (n, 3) and n_eff.shape == scores.shape == (n,)
    refined = scores != -1.0
    np.testing.assert_array_equal(refined, ref_scores != -1.0)
    step = tfs.fastslam_step
    assert step.host_syncs == 0
    assert step.refines == refined.sum() >= 1
    triggered = refined & (n_eff < pf.resample_threshold * P)
    assert step.resamples == triggered.sum()
    assert np.isfinite(traj).all() and np.isfinite(n_eff).all()
    dist = float(np.abs(traj - ref_traj).max())
    ate = ate_rmse(traj, log["gt_poses"], align=False)
    ref_ate = ate_rmse(ref_traj, log["gt_poses"], align=False)
    print(f"{case}: ATE port {ate:.4f}, JAX {ref_ate:.4f}; trajectories "
          f"{dist:.4f} apart")
    if case in TRAJ_HELD:
        assert dist <= 0.25
    assert abs(ate - ref_ate) <= 0.03
    assert state.logodds.shape == (P, 224, 224)
    gated_state, *gated = tfr.run_fastslam(
        log, to_port(CFG), to_port(pf), CPU, draws=draws, host_gated=True)
    for a, b in zip(gated, (traj, n_eff, scores)):
        np.testing.assert_array_equal(a, b)
    assert torch.equal(gated_state.logodds, state.logodds)


def _impl_case(impl):
    """(FrontendConfig, PFConfig) of the step-bits test for `impl`: an
    update_impl of the per-particle update, or "shared" (the shared refine
    and the shared update)."""
    grid_impl, extra = impl, {}
    if impl == "shared":
        grid_impl, extra = "pallas", dict(refine_mode="shared",
                                          update_mode="shared")
    cfg = dataclasses.replace(
        CFG, grid=dataclasses.replace(CFG.grid, update_impl=grid_impl))
    pf = PFConfig(n_particles=STEP_P, resample_threshold=0.9, **NOISE,
                  **extra)
    return to_port(cfg), to_port(pf)


@pytest.mark.parametrize(
    "impl", ["pallas", "pallas_hybrid", "pallas_ray", "sparse", "dense",
             "shared"])
def test_device_gated_step_gives_the_host_step_bits(impl):
    cfg, pf = _impl_case(impl)
    log = pf_log()
    noise, u = (torch.from_numpy(a) for a in
                pf_draws(jax.random.PRNGKey(1), STEP_SCANS, STEP_P))
    odom = torch.from_numpy(log["odom"].astype(np.float32))
    ranges = torch.from_numpy(log["ranges"].astype(np.float32))
    flags = tfs.host_gate_flags(log["odom"], cfg, log["odom"][0], 0.0,
                                np.inf, 0.0)
    host = tfs.fastslam_init(cfg, pf, CPU, start_pose=log["odom"][0])
    dev = tfs.PFState(*(t.clone() for t in host))
    counts = torch.zeros(3, dtype=torch.int64)
    _reset_counts()
    for t in range(STEP_SCANS):
        host, out_h = tfs.fastslam_step(host, odom[t], ranges[t], cfg, pf,
                                        gates=flags[t], noise=noise[t],
                                        u=u[t])
        dev, out_d = tfs.fastslam_step(dev, odom[t], ranges[t], cfg, pf,
                                       noise=noise[t], u=u[t],
                                       host_branch=False, counts=counts)
        for name, a, b in zip(tfs.PFState._fields + ("pose", "n_eff",
                                                     "score"),
                              (*host, *out_h), (*dev, *out_d)):
            assert torch.equal(a, b), f"scan {t}: {name}"
    step = tfs.fastslam_step
    assert counts.tolist() == [step.refines, step.updates, step.resamples]
    assert step.refines == flags[:STEP_SCANS, 0].sum()
    assert step.updates == flags[:STEP_SCANS, 1].sum()
    assert step.resamples >= 1


class _Picked(Exception):
    pass


def _picker(name):
    def pick(*args, **kwargs):
        raise _Picked(name)

    return pick


@pytest.mark.parametrize("particles, threshold", [
    (8, 512), (511, 512), (512, 512), (1000, 512), (16, 16), (15, 16)])
def test_host_gated_none_resolves_as_jax(monkeypatch, particles, threshold):
    cfg = FrontendConfig(sensor=PF_SENSOR,
                         grid=GridConfig(height=16, width=16))
    pf = PFConfig(n_particles=particles, host_gate_min_particles=threshold)
    log = {k: v[:2] for k, v in pf_log().items()}
    monkeypatch.setattr(jfr, "_run_fastslam_host_gated", _picker("host"))
    monkeypatch.setattr(jfr, "make_pf_chunk_fn", _picker("device"))
    monkeypatch.setattr(tfr, "_run_host_gated", _picker("host"))
    monkeypatch.setattr(tfr, "_run_device_gated", _picker("device"))
    picked = []
    for run, extra in ((jfr.run_fastslam, {}),
                       (tfr.run_fastslam, {"device": CPU})):
        for host_gated in (None, True, False):
            with pytest.raises(_Picked) as got:
                run(log, cfg if run is jfr.run_fastslam else to_port(cfg),
                    pf if run is jfr.run_fastslam else to_port(pf),
                    host_gated=host_gated, **extra)
            picked.append(str(got.value))
    want = "host" if particles >= threshold else "device"
    assert picked == [want, "host", "device"] * 2


def test_ungated_run_resumes_a_split_run():
    """A device-gated run split in two, the second part resumed from the
    first part's final state, gives the whole run's bits with the same
    draws, and reads nothing back (the gates are the state's own)."""
    cfg, pf = to_port(CFG), to_port(PFConfig(n_particles=8, **NOISE))
    log = {k: v[:STEP_SCANS] for k, v in pf_log().items()}
    noise, u = pf_draws(jax.random.PRNGKey(0), STEP_SCANS, 8)
    whole = tfr.run_fastslam(log, cfg, pf, CPU, draws=(noise, u),
                             host_gated=False)
    cut = STEP_SCANS // 2 + 3
    state, parts = None, []
    _reset_counts()
    for part in (slice(0, cut), slice(cut, STEP_SCANS)):
        state, *out = tfr.run_fastslam(
            {k: v[part] for k, v in log.items()}, cfg, pf, CPU, state=state,
            draws=(noise[part], u[part]), host_gated=False)
        parts.append(out)
    assert tfs.fastslam_step.host_syncs == 0
    for i in range(3):
        np.testing.assert_array_equal(
            np.concatenate([p[i] for p in parts]), whole[i + 1])
    assert torch.equal(state.logodds, whole[0].logodds)


def test_ungated_frame_cb_is_called_once_a_chunk():
    cfg, pf = to_port(CFG), to_port(PFConfig(n_particles=4, **NOISE))
    n = 20          # two chunks of 8 and a tail of 4
    log = {k: v[:n] for k, v in pf_log().items()}
    frames = []
    _, traj, _, _ = tfr.run_fastslam(
        log, cfg, pf, CPU, seed=3, host_gated=False,
        frame_cb=lambda m, tr: frames.append((tuple(m.shape), tr)))
    assert [f[0] for f in frames] == [(224, 224)] * 3
    np.testing.assert_array_equal(np.concatenate([f[1] for f in frames]),
                                  traj)


def test_no_card_and_no_cpu_graph():
    """No fallback: the default device without a card raises, and a
    chunk graph needs a CUDA device."""
    cfg, pf = to_port(CFG), to_port(PFConfig(n_particles=4))
    log = {k: v[:4] for k, v in pf_log().items()}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tfr.run_fastslam(log, cfg, pf)
    with pytest.raises(ValueError, match="CUDA device"):
        tfr.PFChunkGraph(cfg, pf, CPU, 8)


# ---- each gated plain version at gate 0 and gate 1 ---------------------


def _gate_inputs(dtype=torch.float32):
    rng = np.random.default_rng(7)
    log = pf_log()
    maps = torch.tensor(rng.normal(0, 1.5, (3, 224, 224)).clip(-5, 5),
                        dtype=dtype)
    poses = torch.tensor(
        np.stack([log["odom"][20]] * 3)
        + rng.normal(0, [0.3, 0.3, 0.1], (3, 3)), dtype=torch.float32)
    return maps, poses, torch.tensor(log["ranges"][20], dtype=torch.float32)


def _in_place_call(name, maps, poses, ranges, gate):
    """One in-place gated form on `maps` (modified), from its wrapper."""
    g, s = to_port(CFG.grid), to_port(PF_SENSOR)
    consts = tocc.update_constants(g, s)
    region = (96, 96)
    angles = tocc.beam_angles(s, CPU)
    o = (g.origin_x, g.origin_y)
    if name == "update_ism":
        tupd.update_ism(maps, poses, ranges, region=region, origin_xy=o,
                        gate=gate, **consts)
    elif name == "update_hybrid_particles":
        tupd.update_hybrid_particles(maps, poses, ranges, angles,
                                     region=region, origin_xy=o, gate=gate,
                                     **consts)
    elif name == "update_ray_particles":
        tupd.update_ray_particles(
            maps, poses, ranges, angles, region=region, origin_xy=o,
            resolution=g.resolution, min_range=s.min_range,
            max_range=s.max_range, angle_min=s.angle_min,
            step=consts["step"], l_free=g.l_free, l_occ=g.l_occ,
            l_clamp=g.l_clamp, ray_samples=g.ray_samples, gate=gate)
    elif name == "raycast_update_particles":
        tocc.raycast_update_particles(maps, poses, ranges, g, s, region,
                                      gate=gate)
    elif name == "dense_update_particles":
        tocc.dense_update_particles(maps, poses, ranges, g, s, region,
                                    gate=gate)
    elif name == "shared_apply":
        P = maps.shape[0]
        images = torch.linspace(-0.5, 0.5, 2 * 64 * 64).reshape(2, 64, 64)
        anchors = torch.tensor([[30, 40], [200, 10], [112, 112]],
                               dtype=torch.int32)
        slots = torch.tensor([0, 1, 1], dtype=torch.int32)
        ep_r = torch.tensor([[31, 31, 50]] * P, dtype=torch.int32)
        ep_c = torch.tensor([[41, 41, 20]] * P, dtype=torch.int32)
        ep_w = torch.tensor([[0.85, 0.85, 0.0]] * P)
        tapply.shared_apply(maps, anchors, slots, images, 10.0, ep_r, ep_c,
                            ep_w, gate=gate)
    else:   # the resample's row gather into a given stack
        src = maps.flip(0).contiguous() + 1
        tgather.gather_rows(src, torch.tensor([2, 2, 0], dtype=torch.int32),
                            gate=gate, out=maps)


@pytest.mark.parametrize("name", [
    "update_ism", "update_hybrid_particles", "update_ray_particles",
    "raycast_update_particles", "dense_update_particles", "shared_apply",
    "gather_rows"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gated_plain_version_keeps_its_bits_at_gate_0(name, dtype):
    maps, poses, ranges = _gate_inputs(dtype)
    before = maps.clone()
    _in_place_call(name, maps, poses, ranges, torch.tensor(False))
    assert torch.equal(maps.view(torch.int16 if dtype == torch.bfloat16
                                 else torch.int32),
                       before.view(torch.int16 if dtype == torch.bfloat16
                                   else torch.int32))
    on, ungated = maps.clone(), maps.clone()
    _in_place_call(name, on, poses, ranges, torch.tensor(True))
    _in_place_call(name, ungated, poses, ranges, None)
    assert not torch.equal(on, before)           # the call did something
    assert torch.equal(on, ungated)


def test_out_of_place_gated_forms_take_the_gate():
    """The field, stack and correlation wrappers take a gate; their plain
    versions compute the ungated values (a gate of 0 means the output is
    not read), and a gate on another device or of another type raises."""
    rng = np.random.default_rng(3)
    maps = torch.tensor(rng.normal(0, 2, (2, 40, 40)), dtype=torch.float32)
    origins = torch.tensor([[-3, 5], [10, 12]], dtype=torch.int32)
    taps = np.array([0.25, 0.5, 0.25], np.float32)
    E = torch.tensor(rng.random((2, 3, 12, 12)), dtype=torch.float32)
    Sp = torch.tensor(rng.random((2, 15, 15)), dtype=torch.float32)
    kw = dict(inv_sat=0.5, free_logit=-0.4, free_penalty=0.6)
    for gate in (torch.tensor(False), torch.tensor(True)):
        assert torch.equal(
            tfield.window_field(maps, origins, 16, taps, gate=gate, **kw),
            tfield.window_field(maps, origins, 16, taps, **kw))
        assert torch.equal(tstack.shift_stack(E[0], 3, 3, gate=gate),
                           tstack.shift_stack(E[0], 3, 3))
        assert torch.equal(tcorr.corr_scores(E, Sp, 3, 3, gate=gate),
                           tcorr.corr_scores(E, Sp, 3, 3))
    for bad in (torch.tensor(1), torch.tensor([True, False])):
        with pytest.raises(ValueError, match="gate"):
            tstack.shift_stack(E[0], 3, 3, gate=bad)
