"""PyTorch port: the three sharded pose-graph solvers on worlds of 2 and 4
gloo ranks on the CPU (rank bodies in tests/torch_dist.py), against the
JAX package's on make_particle_mesh(n) and against the port's own
single-device solvers:

- graph/se2_graph.py:make_optimize_sharded (the edge set split, H, b
  and chi2 summed): poses within 5e-3 (tests/test_graph.py's tolerance);
- graph/schur.py:optimize_schur_sharded (4 blocks split over the ranks):
  within 5e-3, theta on the circle (tests/test_schur.py's);
- graph/sparse.py:optimize_cg_sharded (the edge set split, the loop
  candidates all-gathered): within 2e-3, chi2 within 1% (tests/
  test_sparse_graph.py's).

The graph: tests/test_graph.py's drifting square loop, its closure moved
to edge slot 100 and a second loop edge (a diagonal) put in slot 40, so
that the edge slices of every world size hold loop edges on more than
one rank.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist
from slam2d_tpu.graph.schur import optimize_schur_sharded
from slam2d_tpu.graph.se2_graph import PoseGraph, make_optimize_sharded
from slam2d_tpu.graph.sparse import optimize_cg_sharded
from slam2d_tpu.parallel.mesh import make_particle_mesh
from slam2d_tpu_torch.graph import schur as tschur
from slam2d_tpu_torch.graph import se2_graph as tgraph
from slam2d_tpu_torch.graph import sparse as tsparse
from slam2d_tpu_torch.parallel import mesh as pmesh
from tests.test_graph import CFG, _square_loop_graph
from torch_parity import to_port

torch.set_num_threads(1)

N_BLOCKS = 4
TOL = {"dense": 5e-3, "schur": 5e-3, "cg": 2e-3}


def _pose_diff(a, b):
    d = np.abs(np.asarray(a) - np.asarray(b))
    d[:, 2] = np.abs((np.asarray(a)[:, 2] - np.asarray(b)[:, 2] + np.pi)
                     % (2 * np.pi) - np.pi)
    return d.max()


@functools.cache
def _graph():
    """PoseGraph fields as numpy arrays (module docstring)."""
    g, gt, _ = _square_loop_graph(drift=0.15)
    a = {f: np.array(getattr(g, f)) for f in PoseGraph._fields}
    n_e = int(a["n_edges"])
    close = n_e - 1                       # the square's closure edge
    for f in ("edges_ij", "edges_z", "edges_omega", "edge_mask"):
        a[f][100] = a[f][close]
        a[f][close] = 0
    gt = np.asarray(gt)
    c, s = np.cos(gt[0, 2]), np.sin(gt[0, 2])
    d = gt[8, :2] - gt[0, :2]
    a["edges_ij"][40] = (0, 8)
    a["edges_z"][40] = (c * d[0] + s * d[1], -s * d[0] + c * d[1],
                        (gt[8, 2] - gt[0, 2] + np.pi) % (2 * np.pi) - np.pi)
    a["edges_omega"][40] = np.eye(3) * 100.0
    a["edge_mask"][40] = True
    return a


def _jax_graph():
    return PoseGraph(*(jnp.asarray(_graph()[f]) for f in PoseGraph._fields))


def _jax(n):
    mesh = make_particle_mesh(n)
    g = _jax_graph()
    out = {}
    g2, chi = make_optimize_sharded(CFG, mesh)(g)
    out["dense"] = (np.asarray(g2.poses), float(chi))
    g2, chi = optimize_schur_sharded(g, CFG, mesh, n_blocks=N_BLOCKS)
    out["schur"] = (np.asarray(g2.poses), float(chi))
    g2, chi = optimize_cg_sharded(g, CFG, mesh)
    out["cg"] = (np.asarray(g2.poses), float(chi))
    return out


@functools.cache
def _single():
    """The port's single-device solves of the same graph."""
    g = tgraph.PoseGraph(*(torch.as_tensor(_graph()[f])
                           for f in tgraph.PoseGraph._fields))
    cfg = to_port(CFG)
    return {
        "dense": tgraph.optimize(g, cfg),
        "schur": tschur.optimize_schur(g, cfg, N_BLOCKS),
        "cg": tsparse.optimize_cg(g, cfg),
    }


@pytest.fixture(scope="module", params=[2, 4])
def world(request):
    n = request.param
    res = pmesh.spawn(torch_dist.solvers, n, "gloo", "cpu",
                      args=(to_port(CFG), _graph(), N_BLOCKS))
    return n, res, _jax(n)


@pytest.mark.parametrize("solver", ["dense", "schur", "cg"])
def test_sharded_solver_matches_jax(world, solver):
    _, res, ref = world
    k = int(_graph()["n_nodes"])
    poses, chi = res[0][solver]
    for r in res[1:]:
        np.testing.assert_array_equal(r[solver][0], poses)
    assert np.isfinite(poses).all()
    assert _pose_diff(poses[:k], ref[solver][0][:k]) <= TOL[solver]
    assert abs(chi - ref[solver][1]) <= 1e-2 * max(1.0, ref[solver][1])


@pytest.mark.parametrize("solver", ["dense", "schur", "cg"])
def test_sharded_solver_matches_single_device_port(world, solver):
    _, res, _ = world
    k = int(_graph()["n_nodes"])
    g1, chi1 = _single()[solver]
    poses, chi = res[0][solver]
    assert _pose_diff(poses[:k], g1.poses.numpy()[:k]) <= TOL[solver]
    assert abs(chi - float(chi1)) <= 1e-2 * max(1.0, float(chi1))
