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
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam2d_tpu.config import PFConfig
from slam2d_tpu.metrics import ate_rmse
from slam2d_tpu.pf import fastslam as jfs
from slam2d_tpu.run.fastslam_run import run_fastslam as jax_run_fastslam
from slam2d_tpu_torch.grid.occupancy import beam_angles
from slam2d_tpu_torch.ops import update as tupd
from slam2d_tpu_torch.pf import fastslam as tfs
from slam2d_tpu_torch.run.fastslam_run import run_fastslam
from torch_parity import PF_CFG as CFG
from torch_parity import PF_P as P
from torch_parity import PF_SENSOR as SENSOR
from torch_parity import PF_T as T
from torch_parity import pf_draws, pf_log, pf_run_pair, to_port

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
        log, TCFG, to_port(PF), CPU, draws=draws, host_gated=True
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
                                     draws=(noise, u), host_gated=True)
    cut = STEP_SCANS // 2 + 2
    parts = [slice(0, cut), slice(cut, STEP_SCANS)]
    state, trajs, n_effs = None, [], []
    for part in parts:
        _reset_counts()
        state, tr, ne, _ = run_fastslam(
            {k: v[part] for k, v in log.items()}, TCFG, to_port(PF), CPU,
            state=state,
            draws=(noise[part], u[part]), host_gated=True,
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


# ---- the per-particle map updates of every update_impl ------------------
#
# The JAX package's per-particle update is vmap(_windowed_update) (its
# fastslam.py:303); the port updates every particle's window at once. Same
# maps (random log-odds) and poses (one clamped against the map's corner)
# in both. Tolerances: the dense, ISM and hybrid updates bit-exact; the
# sampled-ray update within 1e-5 of log-odds (its per-cell sums add in
# another order in XLA's vmapped scatter), at most 0.05% of cells off by
# more (an endpoint moved by XLA's CPU cos/sin); the exact-ray update as
# tests/test_torch_ray.py holds it: 0.05% of cells may differ by one
# l_occ, the free channel within 2e-3.

UPD_P = 4


@functools.cache
def _update_inputs():
    log = pf_log()
    rng = np.random.default_rng(0)
    maps = rng.normal(0, 1.5, (UPD_P, 224, 224)).astype(np.float32)
    maps = maps.clip(-5, 5)
    poses = np.stack([log["odom"][20]] * UPD_P) + rng.normal(
        0, [0.3, 0.3, 0.1], (UPD_P, 3))
    poses = poses.astype(np.float32)
    poses[1, :2] = [1.0, 1.0]   # the window clamped into the map's corner
    return maps, poses, log["ranges"][20].astype(np.float32)


def _impl_cfg(impl, cfg=CFG):
    return dataclasses.replace(
        cfg, grid=dataclasses.replace(cfg.grid, update_impl=impl))


def _jax_update(impl, maps, poses, ranges, cfg=CFG):
    jcfg = _impl_cfg(impl, cfg)
    return np.asarray(jax.vmap(
        lambda g, p: jfs._windowed_update(g, p, jnp.asarray(ranges), jcfg)
    )(jnp.asarray(maps), jnp.asarray(poses)))


def _port_update(impl, maps, poses, ranges, cfg=CFG):
    out = torch.tensor(maps)
    pf = to_port(PFConfig(n_particles=len(poses), update_mode="per_particle"))
    tfs._update_all(out, torch.tensor(poses), torch.tensor(ranges),
                    to_port(_impl_cfg(impl, cfg)), pf)
    return out.numpy()


@pytest.mark.parametrize(
    "impl", ["sparse", "sparse_mxu", "dense", "pallas_ray", "pallas_hybrid"])
def test_per_particle_update_matches_jax(impl):
    maps, poses, ranges = _update_inputs()
    # "sparse_mxu" is the sampled-ray update that JAX accumulates by a
    # one-hot matmul (reduced precision off its TPU): held to "sparse"
    ref = _jax_update("sparse" if impl == "sparse_mxu" else impl, maps,
                      poses, ranges)
    out = _port_update(impl, maps, poses, ranges)
    assert (ref != maps).mean() > 0.05        # the update did something
    diff = np.abs(out - ref)
    if impl == "dense" or impl == "pallas_hybrid":
        np.testing.assert_array_equal(out, ref)
    elif impl.startswith("sparse"):
        assert (diff > 1e-5).mean() <= 0.0005, diff.max()
    else:
        occ = np.isclose(diff, CFG.grid.l_occ, atol=2e-3)
        assert occ.mean() <= 0.0005
        assert diff[~occ].max() <= 2e-3


@pytest.mark.parametrize("impl", ["pallas_ray", "pallas_hybrid"])
@pytest.mark.parametrize("map_dtype", [torch.float32, torch.bfloat16])
def test_batched_kernel_plain_equals_single_window(impl, map_dtype):
    """The plain version of the particle-batched kernels 1 `ray` and
    `hybrid` equals the single-map update (`integrate_scan` with the
    window's origin) on each particle's window, bit for bit; a bfloat16
    map is updated in float32 and rounded once."""
    from slam2d_tpu_torch.grid.occupancy import integrate_scan, world_to_cell
    from slam2d_tpu_torch.grid.window import (
        extract_window, update_window_cells,
    )

    maps, poses, ranges = _update_inputs()
    cfg = to_port(_impl_cfg(impl))
    stack = torch.tensor(maps).to(map_dtype)
    ref = stack.clone()
    win = update_window_cells(cfg.grid, cfg.sensor)
    r = torch.tensor(ranges)
    for p in range(UPD_P):
        pose = torch.tensor(poses[p])
        center = world_to_cell(pose[:2], cfg.grid).tolist()
        g, orc = extract_window(ref[p].to(torch.float32), center, win)
        g = integrate_scan(g, pose, r, cfg.grid, cfg.sensor, origin_rc=orc)
        ref[p, orc[0]:orc[0] + win, orc[1]:orc[1] + win] = g.to(map_dtype)
    pf = to_port(PFConfig(n_particles=UPD_P, update_mode="per_particle"))
    tfs._update_all(stack, torch.tensor(poses), r, cfg, pf)
    if map_dtype == torch.bfloat16:
        stack, ref = stack.view(torch.int16), ref.view(torch.int16)
    assert torch.equal(stack, ref)


def test_fastslam_270_degree_scanner_matches_jax():
    """FastSLAM with a 270-degree, 271-beam scanner: "auto" resolves to
    the sampled-ray update (the JAX package's choice past pi), which the
    particle filter now runs. Held as test_run_fastslam_matches_jax holds
    its run: a trajectory within 0.25 m of JAX's, an ATE within 0.03 m of
    JAX's."""
    import math

    from slam2d_tpu.config import SensorConfig as JSensor
    from slam2d_tpu.data.synth import SynthWorld, simulate_log

    sensor = JSensor(n_beams=271, fov_rad=1.5 * math.pi,
                     angle_min=-0.75 * math.pi, max_range=8.0)
    cfg = dataclasses.replace(_impl_cfg("auto"), sensor=sensor)
    wp = np.array([[3.0, 3.0], [3.0, 9.0], [9.0, 9.0], [11.0, 4.0]])
    log = simulate_log(SynthWorld.box_rooms(16.0), wp, sensor, step=0.12,
                       odom_noise_xy=0.03, odom_noise_theta=0.012, seed=11)
    log = {k: np.asarray(v)[:T] for k, v in log.items()}
    ref, (traj, n_eff, _), _ = pf_run_pair(PF, cfg, log)
    assert np.isfinite(traj).all() and np.isfinite(n_eff).all()
    assert np.abs(traj - ref[0]).max() <= 0.25
    ate = ate_rmse(traj, log["gt_poses"], align=False)
    ref_ate = ate_rmse(ref[0], log["gt_poses"], align=False)
    print(f"ATE port {ate:.4f}, JAX {ref_ate:.4f}")
    assert abs(ate - ref_ate) <= 0.03


# ---- the particle forms' tables (kernel 1 `ray` and `hybrid` over P windows)
#
# Each block of the particle kernels builds its particle's beam tables once
# (csrc/update_ray.cu, update_hybrid.cu); their plain versions,
# `ray_particle_tables` and `hybrid_particle_tables`, build every
# particle's at once. P = 3 windows of 96^2 in maps of 192^2 at 0.1 m (one
# clamped against the map's corner): the tables equal the single-window
# ones at each window's origin, bit for bit.

TAB_P, TAB_MAP, TAB_WIN = 3, 192, (96, 96)


@functools.cache
def _table_inputs():
    """(grid config, poses [3, 3], ranges) of the tables' tests."""
    g = dataclasses.replace(TCFG.grid, height=TAB_MAP, width=TAB_MAP)
    log = pf_log()
    rng = np.random.default_rng(5)
    poses = np.stack([log["odom"][20]] * TAB_P) + rng.normal(
        0, [0.4, 0.4, 0.2], (TAB_P, 3))
    # windows at columns 23 and 32 of the map (c0 mod 4: 3 and 0), and one
    # clamped against the map's corner
    poses[:, :2] = [[5.55, 5.0], [g.origin_x + 0.35, g.origin_y + 0.2],
                    [6.42, 6.3]]
    return (g, torch.tensor(poses.astype(np.float32)),
            torch.tensor(log["ranges"][20].astype(np.float32)))


def _table_kw(g):
    s = TCFG.sensor
    return dict(region=TAB_WIN, shape=(g.height, g.width),
                origin_xy=(g.origin_x, g.origin_y), resolution=g.resolution,
                min_range=s.min_range, max_range=s.max_range)


@pytest.mark.parametrize("impl", ["pallas_ray", "pallas_hybrid"])
def test_particle_tables_equal_single_window_tables(impl):
    """Every particle's tables, built at once, are the single-window tables
    (`ray_tables`; `hybrid_tables`, which `update_hybrid_plain` builds) at
    that particle's window origin, bit for bit; the window origins are
    `window_origins`' (the clamped one at the map's corner)."""
    g, poses, ranges = _table_inputs()
    angles = beam_angles(TCFG.sensor, CPU)
    kw = _table_kw(g)
    (r0, c0), (ox, oy) = tupd.window_origins(
        poses, TAB_WIN, kw["shape"], kw["origin_xy"], g.resolution)
    assert (r0[1], c0[1]) == (0, 0) and (r0 > 0).sum() == TAB_P - 1
    if impl == "pallas_ray":
        origins, oxy, rays = tupd.ray_particle_tables(
            poses, ranges, angles, ray_samples=g.ray_samples, **kw)
        assert rays.shape == (TAB_P, 9, 120)
    else:
        origins, oxy, rmin3, ends = tupd.hybrid_particle_tables(
            poses, ranges, angles, **kw)
        assert ends.shape == (TAB_P, 120) and (ends >= 0).sum() > 100
    assert torch.equal(torch.stack(origins), torch.stack((r0, c0)))
    assert torch.equal(torch.stack(oxy), torch.stack((ox, oy)))
    del kw["region"], kw["shape"]
    for p in range(TAB_P):
        kw["origin_xy"] = (float(ox[p]), float(oy[p]))
        if impl == "pallas_ray":
            one = tupd.ray_tables(poses[p], ranges, angles,
                                  ray_samples=g.ray_samples, **kw)
            assert torch.equal(rays[p], one)
        else:
            r3, e = tupd.hybrid_tables(poses[p], ranges, angles,
                                       shape=TAB_WIN, **kw)
            assert torch.equal(rmin3, r3) and torch.equal(ends[p], e)


@pytest.mark.parametrize("map_dtype", [torch.float32, torch.bfloat16])
def test_ray_strip_sum_equals_full_sum_on_particle_windows(map_dtype):
    """Kernel 1 `ray`'s particle form sums, in each strip of 4 cells of a
    row, only the beams `ray_strip_beams` keeps, by the skip-zero chain;
    its strips lie on the map's 4-cell lattice, so a window starts c0 mod 4
    cells into its first strip. On every particle's window (a float32 or
    a bfloat16 map's cells) that sum has the full sum's bits, and it keeps
    under a tenth of the (strip, beam) pairs."""
    g, poses, ranges = _table_inputs()
    s = TCFG.sensor
    angles = beam_angles(s, CPU)
    kw = _table_kw(g)
    (r0, c0), (ox, oy), rays = tupd.ray_particle_tables(
        poses, ranges, angles, ray_samples=g.ray_samples, **kw)
    maps = torch.tensor(_update_inputs()[0][:TAB_P, :TAB_MAP, :TAB_MAP])
    maps = maps.to(map_dtype).to(torch.float32)
    up = dict(resolution=g.resolution, l_free=g.l_free, l_occ=g.l_occ,
              l_clamp=g.l_clamp)
    offsets = set()
    for p in range(TAB_P):
        r, c, o = int(r0[p]), int(c0[p]), (float(ox[p]), float(oy[p]))
        win = maps[p, r:r + TAB_WIN[0], c:c + TAB_WIN[1]].contiguous()
        beams = tupd.ray_strip_beams(
            poses[p], ranges, rays[p], TAB_WIN, origin_xy=o,
            resolution=g.resolution, min_range=s.min_range,
            max_range=s.max_range, angle_min=s.angle_min,
            step=s.fov_rad / (s.n_beams - 1), col_offset=c % 4)
        offsets.add(c % 4)
        full = tupd.update_ray_plain(win, poses[p], rays[p], origin_xy=o,
                                     **up)
        strip = tupd.update_ray_plain(win, poses[p], rays[p], origin_xy=o,
                                      beams=beams, col_offset=c % 4, **up)
        assert (full != win).sum() > 1000
        assert torch.equal(strip, full)
        assert beams.float().mean() < 0.1
    assert len(offsets) > 1   # strips both on and off the window's edge
