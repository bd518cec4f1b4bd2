"""PyTorch port: tiled full SLAM with optimizer="schur_sharded" (every
rank runs the whole loop, rank 0's graph broadcast before each solve, the
Schur blocks split over the ranks) on a world of 2 gloo ranks on the CPU
(rank bodies in tests/torch_dist.py; 4 ranks in
tests/test_torch_sharded_tiled_slam_4.py), on
tests/test_torch_full_slam_tiled.py's config and log:

- against the JAX package's run with the same optimizer on
  make_particle_mesh(n) (its mesh patched to the same n devices, so the
  two split the graph into the same n blocks): the same keyframes and
  loops, keyframe poses and the trajectory within 5e-3 m / rad, chi2
  within 0.1% (test_torch_full_slam_tiled.py's tolerances). Every rank
  returns the same result.
- against the port's single-device run with optimizer="schur" (4
  blocks), to the same tolerances (the two partitions differ, the
  algebra is exact).
"""

import functools

import numpy as np
import torch

import slam2d_tpu.parallel.mesh as jmesh
import torch_dist
from slam2d_tpu.run import full_slam_tiled as jfst
from slam2d_tpu_torch.parallel import mesh as pmesh
from slam2d_tpu_torch.run import full_slam_tiled as tfst
from test_torch_full_slam_tiled import CFG, GCFG, JTCFG, TTCFG
from test_torch_full_slam_tiled import _log as tiled_log
from torch_parity import pose_error, to_port

torch.set_num_threads(1)

POSE_TOL = 5e-3
CPU = torch.device("cpu")


def held(out, ref, ranks):
    for r in ranks:
        np.testing.assert_array_equal(r["traj"], out["traj"])
    np.testing.assert_array_equal(out["kf_scan_idx"], ref.kf_scan_idx)
    assert out["n_loops"] == ref.n_loops >= 1
    for a, b in ((out["kf_poses"], ref.kf_poses), (out["traj"], ref.traj)):
        dxy, dth = pose_error(np.asarray(a), np.asarray(b))
        assert dxy <= POSE_TOL and dth <= POSE_TOL, (dxy, dth)
    np.testing.assert_allclose(out["chi2"], ref.chi2, rtol=1e-3)


@functools.cache
def jax_ref(n):
    """JAX's run with "schur_sharded" on an n-device mesh (n blocks), made
    before any of the port's runs in the process
    (test_torch_full_slam_tiled.py's _jax_runs says why)."""
    make = jmesh.make_particle_mesh
    jmesh.make_particle_mesh = (
        lambda n_devices=None, axis="particles": make(n, axis))
    try:
        return jfst.run_full_slam_tiled(tiled_log(), CFG, JTCFG, GCFG,
                                        optimizer="schur_sharded")
    finally:
        jmesh.make_particle_mesh = make


@functools.cache
def port_run(n):
    """The port's run with "schur_sharded" on n gloo ranks (each rank's
    result, in rank order)."""
    return pmesh.spawn(torch_dist.full_slam_tiled, n, "gloo", "cpu", args=(
        tiled_log(), to_port(CFG), TTCFG, to_port(GCFG), "schur_sharded"))


def test_schur_sharded_tiled_full_slam_matches_jax():
    ref = jax_ref(2)
    res = port_run(2)
    held(res[0], ref, res[1:])


def test_schur_sharded_tiled_full_slam_matches_single_device_schur():
    jax_ref(2)
    ref = tfst.run_full_slam_tiled(tiled_log(), to_port(CFG), TTCFG,
                                   to_port(GCFG), optimizer="schur",
                                   device=CPU)
    res = port_run(2)
    held(res[0], ref, res[1:])
