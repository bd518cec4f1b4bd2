"""PyTorch port: full SLAM with optimizer="schur_sharded" (every rank runs
the whole loop, rank 0's graph broadcast before each solve, the Schur blocks
split over the ranks) on worlds of 2 and 4 gloo ranks on the CPU (rank
bodies in tests/torch_dist.py).

- On a bounded grid against the JAX package's run with the same
  optimizer on make_particle_mesh(n) (its mesh patched to n devices):
  tests/test_torch_full_slam.py's config and log, JAX on 4 devices (4
  blocks; the port's 2 ranks run 2), held as its "schur" run is: the
  same keyframes and loop decisions, keyframe poses and the trajectory
  within 5e-3 m / rad, chi2 within 0.1%. Every rank returns the same
  result.
- In a process that joined no world, "schur_sharded" solves as one rank
  would (one block), held as the 2 ranks are against JAX's run on 4
  devices.
- A rank whose graph header differs from rank 0's raises (ranks that
  diverged end in an error, not a hang).
"""

import functools

import numpy as np
import pytest
import torch

import slam2d_tpu.parallel.mesh as jmesh
import torch_dist
from slam2d_tpu.run import full_slam as jfs
from slam2d_tpu_torch.parallel import mesh as pmesh
from test_torch_full_slam import CFG, GCFG, _log
from torch_parity import pose_error, to_port

torch.set_num_threads(1)

POSE_TOL = 5e-3
JAX_DEVICES = 4


def _held(out, ref, ranks):
    for r in ranks:
        np.testing.assert_array_equal(r["traj"], out["traj"])
    np.testing.assert_array_equal(out["kf_scan_idx"], ref.kf_scan_idx)
    assert out["n_loops"] == ref.n_loops >= 1
    for a, b in ((out["kf_poses"], ref.kf_poses), (out["traj"], ref.traj)):
        dxy, dth = pose_error(np.asarray(a), np.asarray(b))
        assert dxy <= POSE_TOL and dth <= POSE_TOL, (dxy, dth)
    np.testing.assert_allclose(out["chi2"], ref.chi2, rtol=1e-3)


@functools.cache
def _jax_ref():
    """JAX's run with "schur_sharded" on a 4-device mesh (4 blocks)."""
    make = jmesh.make_particle_mesh
    jmesh.make_particle_mesh = (
        lambda n_devices=None, axis="particles": make(JAX_DEVICES, axis))
    try:
        return jfs.run_full_slam(_log(), CFG, GCFG, optimizer="schur_sharded")
    finally:
        jmesh.make_particle_mesh = make


@pytest.mark.parametrize("n", [2, 4])
def test_schur_sharded_full_slam_matches_jax(n):
    res = pmesh.spawn(torch_dist.full_slam, n, "gloo", "cpu", args=(
        _log(), to_port(CFG), to_port(GCFG), "schur_sharded"))
    _held(res[0], _jax_ref(), res[1:])


def test_schur_sharded_without_a_world_matches_jax():
    from slam2d_tpu_torch.run.full_slam import run_full_slam

    ref = _jax_ref()
    assert pmesh.joined() is None
    res = run_full_slam(_log(), to_port(CFG), to_port(GCFG),
                        optimizer="schur_sharded", device=torch.device("cpu"))
    out = {"traj": res.traj, "kf_poses": np.asarray(res.kf_poses),
           "kf_scan_idx": np.asarray(res.kf_scan_idx),
           "n_loops": res.n_loops, "chi2": res.chi2}
    _held(out, ref, [])


def test_diverged_graph_header_raises():
    from slam2d_tpu_torch.config import GraphConfig

    with pytest.raises(Exception, match="diverged|header|closed"):
        pmesh.spawn(torch_dist.diverged_graph, 2, "gloo", "cpu",
                    args=(GraphConfig(max_nodes=8, max_edges=8),),
                    timeout_s=60)
