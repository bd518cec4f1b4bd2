"""PyTorch port: the shared-anchor refine (pf/shared_refine.py) against
the JAX package's, jitted, on the CPU (its Pallas kernels in interpret
mode).

Two maps: 384^2, where the JAX package takes its fused field kernel and
its stack kernel (bf16 maps), and 224^2, where it takes the XLA chain
(float32 maps). The particles include one whose window runs off the map
and one whose heading lies beyond every theta slot (it keeps its prior).

Tolerances: XLA's CPU backend fuses the endpoint positions' multiply-add
into an FMA, so a bilinear splat weight can round to the other bf16
neighbour (2 of the scan's endpoints here: 50 of 13.8M stack cells, one
bf16 ulp each). That moves a raw score by up to ~2e-5 and, through the
quadratic sub-cell peak, a pose by up to ~7e-5: scores are held to 5e-5
and poses to 2e-4. No particle's best candidate is within that of its
runner-up here, so every argmax agrees.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam2d_tpu.config import (
    FrontendConfig,
    GridConfig,
    MatcherConfig,
    PFConfig,
    SensorConfig,
)
from slam2d_tpu.data.synth import SynthWorld
from slam2d_tpu.grid.occupancy import integrate_scan
from slam2d_tpu.grid.window import blur_halo_cells, scan_window_cells
from slam2d_tpu.ops.pallas_field import fused_field_supported
from slam2d_tpu.ops.pallas_stack import stack_supported
from slam2d_tpu.pf import fastslam as jfs
from slam2d_tpu.pf import shared_refine as jsr
from slam2d_tpu_torch.pf import fastslam as tfs
from slam2d_tpu_torch.pf import shared_refine as tsr
from torch_parity import to_port

torch.set_num_threads(1)

SENSOR = SensorConfig(n_beams=120, max_range=8.0)
MCFG = MatcherConfig(search_xy=0.25, search_theta=0.12, n_theta=9)
TRUE_POSE = np.array([8.3, 7.6, 0.35], np.float32)
P = 6
SCORE_TOL = 5e-5
POSE_TOL = 2e-4


def _cfg(size):
    return FrontendConfig(
        sensor=SENSOR, matcher=MCFG,
        grid=GridConfig(
            height=size, width=size, resolution=0.1, center_x=8.0,
            center_y=8.0,
        ),
    )


def _scan(world, pose):
    return world.raycast(
        np.asarray(pose, np.float64), np.asarray(SENSOR.beam_angles()),
        SENSOR.max_range,
    ).astype(np.float32)


def _inputs(size, jdtype):
    """P particle maps built by the JAX package from four scans (offset
    per particle), their priors and the scan."""
    cfg = _cfg(size)
    world = SynthWorld.box_rooms(16.0)
    grid = jnp.zeros((size, size), jnp.float32)
    for dp in ([0, 0, 0], [0.3, 0.1, 0.1], [-0.2, 0.2, -0.08],
               [1.0, -0.5, 0.3]):
        p = TRUE_POSE + np.asarray(dp, np.float32)
        grid = integrate_scan(
            grid, jnp.asarray(p), jnp.asarray(_scan(world, p)), cfg.grid,
            SENSOR,
        )
    rng = np.random.default_rng(1)
    priors = np.tile(TRUE_POSE, (P, 1)).astype(np.float32)
    priors[:, :2] += rng.uniform(-0.15, 0.15, (P, 2)).astype(np.float32)
    priors[:, 2] += rng.uniform(-0.05, 0.05, P).astype(np.float32)
    priors[4, 2] += 1.2                       # beyond every theta slot
    # a window that runs off the map's edge
    priors[5, :2] = (-10.5, 3.0) if size == 384 else (0.2, 15.5)
    grids = jnp.stack([grid + 0.3 * k for k in range(P)]).astype(jdtype)
    return cfg, grids, priors, _scan(world, TRUE_POSE)


def _to_torch(jx):
    out = torch.from_numpy(np.array(jx.astype(jnp.float32)))
    return out.to(torch.bfloat16) if jx.dtype == jnp.bfloat16 else out


@pytest.mark.parametrize(
    "size,jdtype,fused", [(384, jnp.bfloat16, True), (224, jnp.float32, False)]
)
def test_shared_refine_matches_jax(size, jdtype, fused):
    cfg, grids, priors, ranges = _inputs(size, jdtype)
    pf = PFConfig(n_particles=P, refine_mode="shared")
    mcfg = jfs.refine_matcher(cfg, pf)
    # which of its paths the JAX package takes at this size
    win = scan_window_cells(cfg.grid, SENSOR, mcfg)
    hw = blur_halo_cells(mcfg, cfg.grid.resolution)
    assert fused_field_supported(size, size, win, max(8, -(-hw // 8) * 8)) == fused
    assert stack_supported(win, 5, 5, 2)

    fn = jax.jit(jsr.shared_refine, static_argnums=(3, 4, 5))
    ref_poses, ref_scores = fn(
        grids, jnp.asarray(ranges), jnp.asarray(priors), cfg, mcfg, pf
    )
    poses, scores = tsr.shared_refine(
        _to_torch(grids), torch.from_numpy(ranges), torch.from_numpy(priors),
        to_port(cfg), tfs.refine_matcher(to_port(cfg), to_port(pf)),
        to_port(pf),
    )
    np.testing.assert_allclose(
        scores.numpy(), np.asarray(ref_scores), rtol=0, atol=SCORE_TOL
    )
    np.testing.assert_allclose(
        poses.numpy(), np.asarray(ref_poses), rtol=0, atol=POSE_TOL
    )
    # the far-heading particle keeps its prior; the others matched
    np.testing.assert_array_equal(poses[4].numpy(), priors[4])
    assert (scores[:4].numpy() > MCFG.min_score).all()


def test_endpoint_shift_stack_matches_jax():
    world = SynthWorld.box_rooms(16.0)
    ranges = _scan(world, TRUE_POSE)
    thetas = np.float32(0.35) + (
        np.arange(15, dtype=np.float32) - 7.0
    ) * np.float32(0.03)
    fn = jax.jit(jsr.endpoint_shift_stack, static_argnums=(1, 3, 4, 5, 6, 7))
    ref = fn(
        jnp.asarray(ranges), SENSOR, jnp.asarray(thetas), 192, 5, 5, 0.1,
        jnp.bfloat16,
    )
    ref = np.asarray(ref.astype(jnp.float32))
    out = tsr.endpoint_shift_stack(
        torch.from_numpy(ranges), to_port(SENSOR), torch.from_numpy(thetas),
        192, 5,
        5, 0.1, torch.bfloat16,
    )
    assert out.dtype == torch.bfloat16 and out.shape == ref.shape
    diff = np.abs(out.float().numpy() - ref)
    print("stack cells differing:", int((diff != 0).sum()), "of", diff.size)
    assert (diff != 0).mean() <= 1e-5
    # one bf16 ulp of the value (weights sum to at most a few per cell)
    assert (diff <= 2.0 ** -7 * np.maximum(np.abs(ref), 2.0 ** -8)).all()
    assert ref.sum() > 100


def test_theta_grid_and_refine_matcher_match_jax():
    for m in (MCFG, dataclasses.replace(MCFG, n_theta=1)):
        for pad in (0, 3):
            assert tsr._global_theta_grid(
                to_port(m), pad
            ) == jsr._global_theta_grid(m, pad)
    cfg = _cfg(224)
    for pf in (PFConfig(), PFConfig(refine_prior_weight=16.0, refine_xy=0.2,
                                    refine_n_theta=7)):
        assert tfs.refine_matcher(to_port(cfg), to_port(pf)) == to_port(
            jfs.refine_matcher(cfg, pf)
        )


def test_refine_mode_resolves_as_on_the_accelerator():
    # "auto" takes the shared refine from refine_shared_min_particles on
    # (the JAX package does so on its accelerator only)
    auto = to_port(PFConfig(refine_mode="auto"))
    mcfg = to_port(MCFG)
    assert tfs._resolve_refine_mode(auto, mcfg, 32) == "shared"
    assert tfs._resolve_refine_mode(auto, mcfg, 31) == "per_particle"
    theta_less = dataclasses.replace(mcfg, n_theta=1)
    assert tfs._resolve_refine_mode(auto, theta_less, 64) == "per_particle"
    for mode in ("shared", "per_particle"):
        pf = PFConfig(refine_mode=mode)
        assert tfs._resolve_refine_mode(to_port(pf), mcfg, 8) == (
            jfs._resolve_refine_mode(pf, MCFG, 8)
        )
    with pytest.raises(ValueError):
        tfs._resolve_refine_mode(
            to_port(PFConfig(refine_mode="shared")), theta_less, 8
        )
