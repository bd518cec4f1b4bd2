"""PyTorch port: the correlation scorer (kernel 5, ops/corr.py), the "cmx"
score_offsets and the batched per-particle refine against the JAX
package's (CPU; its Pallas kernel in interpret mode).

Tolerances:
- corr_scores against corr_scores_pallas: the two sum each lag's
  products in different orders, so they agree within 1e-5 relative to
  the sum of |terms| (float32 rounding of ~83k-term sums; measured far
  below that).
- score_offsets "cmx" against JAX's: 2e-6 (float32 summation order again,
  over scores of order 1, after the division by the valid-beam count).
  Splat weights are rounded to bf16 in both; the port rounds the sums of
  at most four corner products per cell as JAX does.
- The per-particle refine against JAX's _refine_all: poses 2e-4, scores
  5e-5 (as the shared refine's: a splat weight that XLA's fused
  multiply-add rounds to the other bf16 neighbour moves a score by ~1e-5,
  and the quadratic sub-cell peak a pose by ~1e-4).
- A short run: ATE within 0.03 m of JAX's (the filter amplifies last-bit
  differences through the map updates and resampling).
"""

import dataclasses

import chip_smoke
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam2d_tpu.config import FrontendConfig, GridConfig, MatcherConfig, PFConfig
from slam2d_tpu.grid import occupancy as jocc
from slam2d_tpu.match import correlative as jcor
from slam2d_tpu.metrics import ate_rmse
from slam2d_tpu.ops.pallas_corr import corr_scores_pallas
from slam2d_tpu.pf import fastslam as jfs
from slam2d_tpu_torch.grid import occupancy as tocc
from slam2d_tpu_torch.match import correlative as tcor
from slam2d_tpu_torch.ops import corr as tcorr
from slam2d_tpu_torch.pf import fastslam as tfs
from torch_parity import (
    PF_CFG,
    PF_P,
    PF_SENSOR,
    SENSOR,
    pf_log,
    pf_run_pair,
    synth_ranges,
    to_port,
)

torch.set_num_threads(1)

POSE = np.array([6.3, 5.8, 0.4], np.float32)
POSE_TOL, SCORE_TOL = 2e-4, 5e-5


@pytest.mark.parametrize("edtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("T,H,W,R", [(3, 24, 40, 5), (2, 17, 9, 3)])
def test_corr_plain_matches_pallas(edtype, T, H, W, R):
    rng = np.random.default_rng(3)
    P = 2
    E = rng.uniform(0, 1, (P, T, H, W)).astype(np.float32)
    E[E < 0.7] = 0.0                                  # sparse, like a splat
    Sp = rng.uniform(-0.6, 1.0, (P, H + R, W + R)).astype(np.float32)
    Sp[:, H:, :] = 0.0
    Sp[:, :, W:] = 0.0
    jE = jnp.asarray(E).astype(jnp.dtype(edtype))
    ref = np.stack([
        np.asarray(corr_scores_pallas(jE[p], jnp.asarray(Sp[p]), R, R,
                                      interpret=True))
        for p in range(P)
    ])
    tE = torch.from_numpy(np.array(jE.astype(jnp.float32))).to(
        getattr(torch, edtype)
    )
    out = tcorr.corr_scores(tE, torch.from_numpy(Sp), R, R)
    assert out.shape == (P, T, R * R) and out.dtype == torch.float32
    scale = np.abs(np.asarray(jE.astype(jnp.float32))).sum(axis=(2, 3))
    tol = np.broadcast_to(1e-5 * scale[:, :, None] + 1e-7, ref.shape)
    np.testing.assert_array_less(np.abs(out.numpy() - ref), tol)


@pytest.mark.parametrize("edtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("case", list(chip_smoke.CORR_EDGE_CASES))
def test_corr_plain_matches_pallas_on_edge_operands(case, edtype):
    """chip_smoke.py's corr_edge_operands (every R, vector and scalar forms
    of the kernel, a dense and a zero image, nonzeros on every edge cell),
    each particle through corr_scores_pallas, within chip_smoke.py's
    corr_tolerance (the card check's)."""
    op = chip_smoke.corr_edge_operands(case, edtype)
    E, Sp, R = op["E"], op["Sp"], op["R"]
    jE = jnp.asarray(E).astype(jnp.dtype(edtype))
    ref = np.stack([
        np.asarray(corr_scores_pallas(jE[p], jnp.asarray(Sp[p]), R, R,
                                      interpret=True))
        for p in range(E.shape[0])
    ])
    tE = torch.from_numpy(E).to(getattr(torch, edtype))
    tSp = torch.from_numpy(Sp)
    out = tcorr.corr_scores(tE, tSp, R, R)
    assert out.shape == ref.shape == (2, 3, R * R)
    tol = np.broadcast_to(chip_smoke.corr_tolerance(tE, tSp).numpy(), ref.shape)
    np.testing.assert_array_less(np.abs(out.numpy() - ref), tol)
    assert not ref[1, 2].any() and np.abs(ref[0, 0]).max() > 0.1


@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("case", list(chip_smoke.CORR_EDGE_CASES))
def test_corr_bound_counts_the_cells_under_the_lags(case, sparse):
    """chip_smoke.py's bound of kernel 5 reads E whole and each cell of Sp
    under the R x R lags of a nonzero E cell of any theta of its particle
    once, counted here cell by cell: on corr_edge_operands (a dense image,
    nonzero borders) and on the same shapes with a few nonzero cells an
    image, some on the last row or column."""
    op = _corr_bound_operands(case, sparse)
    E, Sp, R = op["E"], op["Sp"], op["R"]
    P, T, H, W = E.shape
    cells = {
        (p, h + dr, w + dc)
        for p, t, h, w in zip(*np.nonzero(E))
        for dr in range(R) for dc in range(R)
    }
    nnz = int(np.count_nonzero(E))
    bound = chip_smoke.corr_bound(torch.from_numpy(E).to(torch.bfloat16),
                                  torch.from_numpy(Sp), R)
    assert 0 < len(cells) < Sp.size
    assert bound["bytes"] == 2 * E.size + 4 * len(cells) + 4 * P * T * R * R
    assert bound["operations"] == 2 * nnz * R * R


def _corr_bound_operands(case, sparse):
    """corr_edge_operands(case, "bfloat16"), or with `sparse` E of its shape
    holding 6 nonzero cells an image, drawn from a seed (one image all
    zero, one on the last row and column)."""
    op = chip_smoke.corr_edge_operands(case, "bfloat16")
    if sparse:
        E = op["E"]
        rng = np.random.default_rng(len(case))
        P, T, H, W = E.shape
        E[:] = 0.0
        for p in range(P):
            for t in range(T):
                E[p, t, rng.integers(0, H, 6), rng.integers(0, W, 6)] = 0.5
        E[0, 1, H - 1, W - 1] = 0.25
        E[1, 2] = 0.0
    return op


@pytest.mark.parametrize("bilinear", [True, False])
@pytest.mark.parametrize("case", ["inside", "edge", "nan"])
def test_score_offsets_cmx_matches_jax(bilinear, case):
    rng = np.random.default_rng(7)
    S = rng.uniform(-0.6, 1.0, (60, 72)).astype(np.float32)
    ranges = synth_ranges(POSE)
    if case == "nan":
        ranges[::5] = np.nan
    origin = (5.0, 4.5) if case != "edge" else (6.9, 6.1)
    cell = 0.1 if bilinear else 0.4
    radius = 4 if bilinear else 2
    dth = np.linspace(-0.1, 0.1, 5).astype(np.float32)
    prior = POSE + np.array([0.03, -0.02, 0.01], np.float32)
    offs = jnp.arange(-radius, radius + 1, dtype=jnp.int32)

    @jax.jit
    def ref_fn(S, prior, ranges, dth):
        pts, valid = jocc.scan_endpoints_local(ranges, SENSOR)
        return jcor.score_offsets(
            S, prior, pts, valid, dth, offs, offs, cell,
            jnp.asarray(origin, jnp.float32), bilinear=bilinear, impl="cmx",
        )

    ref = np.asarray(ref_fn(*map(jnp.asarray, (S, prior, ranges, dth))))
    pts, valid = tocc.scan_endpoints_local(
        torch.from_numpy(ranges), to_port(SENSOR)
    )
    out = tcor.score_offsets(
        torch.from_numpy(S), torch.from_numpy(prior), pts, valid,
        torch.from_numpy(dth), radius, cell, origin, bilinear=bilinear,
        impl="cmx",
    ).numpy()
    assert out.shape == ref.shape == (5, 2 * radius + 1, 2 * radius + 1)
    assert np.isfinite(out).all() and np.abs(ref).max() > 0.01
    np.testing.assert_allclose(out, ref, rtol=0, atol=2e-6)


def test_score_impl_resolution():
    r = tcor.resolve_score_impl
    assert [r(i) for i in ("auto", "gather", "pallas")] == ["gather"] * 3
    assert [r(i) for i in ("auto_refine", "cmx", "emx")] == [
        "cmx", "cmx", "emx"
    ]
    for impl in ("mxu", "mxu_int8"):
        with pytest.raises(NotImplementedError):
            r(impl)
    with pytest.raises(ValueError):
        r("nope")


def _refine_case(kind):
    """(cfg, maps [P, H, W] float32, priors, ranges) of one refine case:
    "windowed" (a 224^2 map, a 192^2 scan window), "whole" (a 128^2 map
    the window covers) or "coarse" (search_xy 0.5: a coarse pass, then
    the fine_theta_bins slice, over the whole 224^2 map the wider window
    covers)."""
    size = {"windowed": 224, "whole": 128, "coarse": 224}[kind]
    cfg = dataclasses.replace(
        PF_CFG,
        grid=dataclasses.replace(PF_CFG.grid, height=size, width=size,
                                 center_x=size * 0.05, center_y=size * 0.05),
    )
    if kind == "coarse":
        cfg = dataclasses.replace(
            cfg, matcher=dataclasses.replace(cfg.matcher, search_xy=0.5),
        )
    log = pf_log()
    world_pose = log["gt_poses"][30]
    g = jnp.zeros((size, size), jnp.float32)
    for k in (22, 26, 30, 34):
        g = jocc.integrate_scan(
            g, jnp.asarray(log["gt_poses"][k]), jnp.asarray(log["ranges"][k]),
            cfg.grid, cfg.sensor,
        )
    rng = np.random.default_rng(4)
    maps = np.stack([np.asarray(g) + 0.2 * k for k in range(PF_P)])
    priors = np.tile(world_pose, (PF_P, 1)).astype(np.float32)
    priors[:, :2] += rng.uniform(-0.12, 0.12, (PF_P, 2)).astype(np.float32)
    priors[:, 2] += rng.uniform(-0.05, 0.05, PF_P).astype(np.float32)
    priors[PF_P - 1, :2] = (0.3, size * 0.1 - 0.4)   # a clamped window
    return cfg, maps.astype(np.float32), priors, log["ranges"][30]


@pytest.mark.parametrize("kind", ["windowed", "whole", "coarse"])
def test_per_particle_refine_matches_jax(kind):
    cfg, maps, priors, ranges = _refine_case(kind)
    pf = PFConfig(n_particles=PF_P, refine_mode="per_particle",
                  refine_score_impl="cmx")
    fn = jax.jit(jfs._refine_all, static_argnums=(3, 4))
    ref_poses, ref_scores = fn(
        jnp.asarray(maps), jnp.asarray(ranges), jnp.asarray(priors), cfg, pf
    )
    poses, scores = tfs._refine_all(
        torch.from_numpy(maps), torch.from_numpy(ranges),
        torch.from_numpy(priors), to_port(cfg), to_port(pf),
    )
    np.testing.assert_allclose(
        scores.numpy(), np.asarray(ref_scores), rtol=0, atol=SCORE_TOL
    )
    np.testing.assert_allclose(
        poses.numpy(), np.asarray(ref_poses), rtol=0, atol=POSE_TOL
    )
    assert (scores.numpy()[:-1] > cfg.matcher.min_score).all()
    assert (poses.numpy()[:-1] != priors[:-1]).any()


def test_per_particle_refine_is_the_auto_mode_below_32_particles():
    cfg = to_port(PF_CFG)
    mcfg = tfs.refine_matcher(cfg, to_port(PFConfig(n_particles=PF_P)))
    assert mcfg.score_impl == "auto_refine"
    assert tcor.resolve_score_impl(mcfg.score_impl) == "cmx"
    assert tfs._resolve_refine_mode(
        to_port(PFConfig(n_particles=PF_P)), mcfg, PF_P
    ) == "per_particle"


def test_run_fastslam_per_particle_matches_jax():
    pf = PFConfig(n_particles=PF_P, refine_mode="per_particle",
                  refine_score_impl="cmx", noise_xy=0.02, noise_theta=0.01)
    log = {k: v[:32] for k, v in pf_log().items()}   # a multiple of chunk 8
    (ref_traj, _, ref_scores), (traj, n_eff, scores), _ = pf_run_pair(
        pf, log=log
    )
    np.testing.assert_array_equal(scores != -1.0, ref_scores != -1.0)
    assert np.isfinite(traj).all() and np.isfinite(n_eff).all()
    ate = ate_rmse(traj, log["gt_poses"], align=False)
    ref_ate = ate_rmse(ref_traj, log["gt_poses"], align=False)
    ate_odom = ate_rmse(log["odom"], log["gt_poses"], align=False)
    print(f"ATE port {ate:.4f}, JAX {ref_ate:.4f}, odometry {ate_odom:.4f}")
    assert abs(ate - ref_ate) <= 0.03


@pytest.mark.parametrize("bad", ["E_dtype", "Sp_shape", "sizes", "device"])
def test_corr_wrapper_rejects_bad_input(bad):
    E, Sp, R = torch.zeros(2, 3, 16, 16), torch.zeros(2, 21, 21), 5
    if bad == "E_dtype":
        E = E.double()
    elif bad == "Sp_shape":
        Sp = torch.zeros(2, 20, 21)
    elif bad == "sizes":
        E, Sp, R = torch.zeros(2, 3, 16, 16), torch.zeros(2, 20, 20), 4
    else:
        E, Sp = E.to("meta"), Sp.to("meta")
    with pytest.raises(ValueError):
        tcorr.corr_scores(E, Sp, R, R)


def test_match_scans_needs_the_correlation_scorer():
    """The batched match batches with the correlation scorer (kernel 5)
    only: "gather", whose scorer takes one search space a launch, runs
    the match particle by particle and holds to JAX's vmapped gather
    match to the refine's tolerances; the TPU-only "mxu" raises."""
    cfg = to_port(PF_CFG)
    with pytest.raises(NotImplementedError):
        tcor.match_scans(
            torch.zeros(1, 64, 64), torch.zeros(1, 2),
            torch.ones(PF_SENSOR.n_beams), torch.zeros(1, 3), cfg.grid,
            dataclasses.replace(cfg.matcher, score_impl="mxu"), cfg.sensor,
        )
    cfg, maps, priors, ranges = _refine_case("windowed")
    pf = PFConfig(n_particles=PF_P, refine_mode="per_particle",
                  refine_score_impl="gather")
    fn = jax.jit(jfs._refine_all, static_argnums=(3, 4))
    ref_poses, ref_scores = fn(
        jnp.asarray(maps), jnp.asarray(ranges), jnp.asarray(priors), cfg, pf
    )
    poses, scores = tfs._refine_all(
        torch.from_numpy(maps), torch.from_numpy(ranges),
        torch.from_numpy(priors), to_port(cfg), to_port(pf),
    )
    np.testing.assert_allclose(
        scores.numpy(), np.asarray(ref_scores), rtol=0, atol=SCORE_TOL
    )
    np.testing.assert_allclose(
        poses.numpy(), np.asarray(ref_poses), rtol=0, atol=POSE_TOL
    )


def test_frontend_match_scan_with_cmx_matches_jax():
    """match_scan with score_impl="cmx" (the frontend's matcher, when a
    config pins the correlation scorer) against JAX's, with a coarse
    pass."""
    gcfg = GridConfig(height=200, width=200, resolution=0.1, center_x=10.0,
                      center_y=10.0)
    mcfg = MatcherConfig(search_xy=0.3, search_theta=0.15, n_theta=13,
                         score_impl="cmx")
    g = jocc.make_grid(gcfg)
    for k in range(5):
        p = POSE + np.float32(k) * np.array([0.2, 0.1, 0.02], np.float32)
        g = jocc.integrate_scan(
            g, jnp.asarray(p), jnp.asarray(synth_ranges(p)), gcfg, SENSOR
        )
    lo = np.array(g)
    true_pose = POSE + np.array([0.4, 0.2, 0.04], np.float32)
    prior = true_pose + np.array([0.12, -0.08, 0.05], np.float32)
    ranges = synth_ranges(true_pose)
    fn = jax.jit(lambda lo, r, p: jcor.match_scan(lo, r, p, gcfg, mcfg, SENSOR))
    jp, js = fn(jnp.asarray(lo), jnp.asarray(ranges), jnp.asarray(prior))
    tp, ts = tcor.match_scan(
        torch.from_numpy(lo), torch.from_numpy(ranges),
        torch.from_numpy(prior), to_port(gcfg), to_port(mcfg),
        to_port(SENSOR),
    )
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0,
                               atol=POSE_TOL)
    assert abs(float(ts) - float(js)) <= SCORE_TOL
    assert float(ts) > mcfg.min_score


def test_pf_config_is_shared_with_the_parity_helpers():
    assert isinstance(PF_CFG, FrontendConfig) and PF_CFG.grid.height == 224
