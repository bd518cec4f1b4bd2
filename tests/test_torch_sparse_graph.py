"""PyTorch port: the matrix-free and hierarchical pose-graph solvers
(graph/sparse.py) against the JAX package's, and the cases of
tests/test_sparse_graph.py but the sharded one, on the CPU.

Tolerances:
- the block-Thomas factor (the kernel's plain version, cofactor inverse)
  against JAX's `_tridiag_factor` (LU inverse): 1e-5 relative to the
  largest entry; against float64 inverses of the dense T's leading
  blocks: 1e-5 relative;
- the tridiagonal solve against a dense float64 solve: 5e-4, the JAX
  test's (its scans are another prefix tree than JAX's);
- the assembly: every block 2e-5 relative to the largest (the segment
  sums add in another order; the port's Jacobians are closed-form);
- `optimize_cg` against the port's dense solve: the JAX test's 1e-3
  (2e-3 robust); against JAX's `optimize_cg`: 1e-3;
- `optimize_hier` against JAX's on the 1024-node serpentine: 2e-3 m / rad
  (measured 1.7e-4: the V-cycle's float32 coarse solve is ill
  conditioned, so both packages land at the float32 noise floor, 2e-5 to
  5e-5 m from the truth); the 4096-node case is held to the JAX test's
  bounds (5x below odometry's error, chi2 < 1).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam2d_tpu.config import GraphConfig
from slam2d_tpu.graph import se2_graph as jg
from slam2d_tpu.graph import sparse as js
from slam2d_tpu_torch.graph import se2_graph as tg
from slam2d_tpu_torch.graph import sparse as ts
from slam2d_tpu_torch.ops import tridiag
from slam2d_tpu_torch.run.bench_configs import serpentine_graph_arrays
from test_graph import CFG, _square_loop_graph
from torch_parity import pose_error, to_port

torch.set_num_threads(1)

CPU = torch.device("cpu")
BLOCK_RTOL = 2e-5


def _port(g) -> tg.PoseGraph:
    """The port's PoseGraph of a JAX PoseGraph (numpy copies)."""
    return tg.PoseGraph(*(torch.tensor(np.array(x)) for x in g))


def _close(a, b, rtol):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = max(float(np.abs(b).max()), 1e-30)
    np.testing.assert_allclose(a, b, rtol=0, atol=rtol * scale)


def _pose_diff(a, b):
    dxy, dth = pose_error(np.asarray(a), np.asarray(b))
    return max(dxy, dth)


def _tridiag_system(K=17, seed=3):
    """tests/test_sparse_graph.py's random SPD block-tridiagonal system:
    (D, O [K, 3, 3] float32, the dense float64 T, r [K, 3])."""
    rng = np.random.default_rng(seed)
    D = np.zeros((K, 3, 3), np.float32)
    O = np.zeros((K, 3, 3), np.float32)
    for k in range(K):
        a = rng.normal(size=(3, 3))
        D[k] = a @ a.T + 4.0 * np.eye(3)
        if k < K - 1:
            O[k] = 0.5 * rng.normal(size=(3, 3))
    T = np.zeros((3 * K, 3 * K), np.float64)
    for k in range(K):
        T[3 * k : 3 * k + 3, 3 * k : 3 * k + 3] = D[k]
        if k < K - 1:
            T[3 * k : 3 * k + 3, 3 * k + 3 : 3 * k + 6] = O[k]
            T[3 * k + 3 : 3 * k + 6, 3 * k : 3 * k + 3] = O[k].T
    r = rng.normal(size=(K, 3)).astype(np.float32)
    return D, O, T, r


def test_tridiag_solve_matches_dense():
    D, O, T, r = _tridiag_system()
    want = np.linalg.solve(T, r.reshape(-1)).reshape(-1, 3)
    Cinv = tridiag.tridiag_factor(torch.from_numpy(D), torch.from_numpy(O))
    got = ts._tridiag_apply(Cinv, torch.from_numpy(O), torch.from_numpy(r))
    np.testing.assert_allclose(got.numpy(), want, atol=5e-4)


def test_tridiag_factor_plain_is_the_inverse_schur_complement():
    """Cinv[k] is the inverse of the Schur complement of T's leading k + 1
    blocks: the last diagonal block of their dense inverse
    (torch.linalg.inv in float64)."""
    D, O, T, _ = _tridiag_system()
    Cinv = tridiag.tridiag_factor_plain(torch.from_numpy(D),
                                        torch.from_numpy(O)).numpy()
    Td = torch.from_numpy(T)
    for k in range(len(D)):
        n = 3 * (k + 1)
        want = torch.linalg.inv(Td[:n, :n])[-3:, -3:].numpy()
        _close(Cinv[k], want, 1e-5)


def test_tridiag_factor_matches_jax():
    D, O, _, _ = _tridiag_system(K=64, seed=5)
    want = np.asarray(jax.jit(js._tridiag_factor)(jnp.asarray(D),
                                                  jnp.asarray(O)))
    got = tridiag.tridiag_factor(torch.from_numpy(D), torch.from_numpy(O))
    _close(got.numpy(), want, 1e-5)


def test_tridiag_factor_checks_operands():
    D = torch.zeros((4, 3, 3))
    with pytest.raises(ValueError):
        tridiag.tridiag_factor(D, torch.zeros((5, 3, 3)))
    with pytest.raises(ValueError):
        tridiag.tridiag_factor(D.double(), D.double())


def test_affine_scan_matches_jax():
    rng = np.random.default_rng(1)
    A = (0.5 * rng.normal(size=(37, 3, 3))).astype(np.float32)
    C = rng.normal(size=(37, 3, 5)).astype(np.float32)
    want = np.asarray(js._affine_scan(jnp.asarray(A), jnp.asarray(C)))
    got = ts._affine_scan(torch.from_numpy(A), torch.from_numpy(C)).numpy()
    _close(got, want, 1e-5)


def test_segmented_compose_matches_jax():
    rng = np.random.default_rng(2)
    z = rng.normal(0.0, 0.3, (50, 3)).astype(np.float32) + [1.0, 0.0, 0.0]
    z = z.astype(np.float32)
    want = np.asarray(js._segmented_compose(jnp.asarray(z), 50, 8))
    got = ts._segmented_compose(torch.from_numpy(z), 50, 8).numpy()
    assert _pose_diff(got, want) < 1e-5


def test_assemble_matches_dense_H():
    """(D, O, b) against the port's dense normal equations plus the
    damping (tests/test_sparse_graph.py's checks) and against JAX's
    `_assemble_sparse`."""
    g, _, _ = _square_loop_graph(drift=0.15)
    pg = _port(g)
    K = g.poses.shape[0]
    n = int(g.n_nodes)
    cfg = to_port(CFG)
    plan = ts.sparse_plan(pg, cfg, CPU, hier=False)
    D, O, b, chi, free, _ = ts._assemble_sparse(pg.poses, pg, None,
                                                cfg.damping, plan.levels[0])
    Hd, bd, chid = tg.assemble_normal_eq(pg.poses, pg.edges_ij, pg.edges_z,
                                         pg.edges_omega, pg.edge_mask, K)
    Hd, bd = Hd.numpy(), bd.numpy()
    np.testing.assert_allclose(float(chi), float(chid), rtol=1e-5)
    assert float(free[0]) == 0.0
    np.testing.assert_allclose(D[0].numpy(), np.eye(3))
    np.testing.assert_allclose(b[0].numpy(), 0.0)
    for k in range(1, n):
        want = Hd[3 * k : 3 * k + 3, 3 * k : 3 * k + 3] + cfg.damping * np.eye(3)
        np.testing.assert_allclose(D[k].numpy(), want, atol=1e-2)
        np.testing.assert_allclose(b[k].numpy(), bd[3 * k : 3 * k + 3],
                                   atol=1e-3)
    for k in range(1, n - 1):
        np.testing.assert_allclose(
            O[k].numpy(), Hd[3 * k : 3 * k + 3, 3 * k + 3 : 3 * k + 6],
            atol=1e-2)
    np.testing.assert_allclose(O[0].numpy(), 0.0)   # pair (0, 1) clamped
    with jax.default_matmul_precision("highest"):
        ref = js._assemble_sparse(g.poses, g, None, CFG.damping)
    for got, want in zip((D, O, b, free), ref[:3] + (ref[4],)):
        _close(got.numpy(), want, BLOCK_RTOL)


def test_optimize_cg_matches_dense():
    """optimize_cg == the dense optimize on the square loop, closes the
    loop, and lands within 1e-3 of JAX's optimize_cg."""
    g, gt, _ = _square_loop_graph(drift=0.15)
    n = int(g.n_nodes)
    cfg = to_port(CFG)
    g_d, chi_d = tg.optimize(_port(g), cfg)
    g_s, chi_s = ts.optimize_cg(_port(g), cfg)
    assert _pose_diff(g_s.poses[:n], g_d.poses[:n]) < 1e-3
    assert abs(float(chi_s) - float(chi_d)) < 1e-2 * max(1.0, float(chi_d))
    assert np.abs(g_s.poses[:n, :2].numpy() - gt[:, :2]).max() < 0.1
    g_j, chi_j = js.optimize_cg(g, CFG)
    assert _pose_diff(g_s.poses[:n], g_j.poses[:n]) < 1e-3
    assert abs(float(chi_s) - float(chi_j)) < 1e-2 * max(1.0, float(chi_j))


def test_optimize_cg_robust_matches_dense():
    """DCS + GNC with a grossly false loop edge: the port's optimize_cg
    against its dense optimize (2e-3, the JAX test's) and JAX's
    optimize_cg (2e-3)."""
    jcfg = GraphConfig(max_nodes=64, max_edges=128, gn_iters=15,
                       robust_kind="dcs", robust_delta=3.0,
                       robust_gnc_iters=2)
    g, _, _ = _square_loop_graph(drift=0.15)
    g = jg.add_edge(g, int(g.n_nodes) - 3, 1,
                    jnp.asarray([3.0, 0.0, 0.0], jnp.float32),
                    jnp.eye(3) * 1000.0)
    n = int(g.n_nodes)
    cfg = to_port(jcfg)
    g_d, _ = tg.optimize(_port(g), cfg)
    g_s, _ = ts.optimize_cg(_port(g), cfg)
    assert _pose_diff(g_s.poses[:n], g_d.poses[:n]) < 2e-3
    g_j, _ = js.optimize_cg(g, jcfg)
    assert _pose_diff(g_s.poses[:n], g_j.poses[:n]) < 2e-3


def _serpentine(K, n_loops):
    arrays, gt, est, ckw = serpentine_graph_arrays(K, n_loops, drift=0.01)
    jcfg = GraphConfig(**ckw, sparse_max_loops=128)
    return arrays, gt, est, jcfg


def _xy_err(poses, gt):
    p = np.asarray(poses, np.float64)
    return float(np.sqrt(np.mean(np.sum((p[:, :2] - gt[:, :2]) ** 2, 1))))


def test_optimize_hier_4096_nodes():
    """tests/test_sparse_graph.py's stress case: 4096 keyframes, 120 loop
    edges; the hierarchical solver cuts the trajectory error at least 5x
    (JAX: 3.37 -> 7.4e-5 m) with chi2 < 1."""
    arrays, gt, est, jcfg = _serpentine(4096, 120)
    g = tg.PoseGraph(**{k: torch.tensor(v) for k, v in arrays.items()})
    g2, chi = ts.optimize_hier(g, to_port(jcfg))
    out = g2.poses.numpy()
    assert np.isfinite(out).all()
    assert _xy_err(out, gt) < _xy_err(est, gt) / 5.0
    assert float(chi) < 1.0


def test_optimize_hier_matches_jax_serpentine():
    """A 1024-node serpentine with 30 rung closures (one V-cycle level:
    64 anchors solved dense at hier_dense_max 512, then the PCG polish):
    the port's poses within 2e-3 of JAX's, both far below odometry's
    error; the stages counted."""
    arrays, gt, est, jcfg = _serpentine(1024, 30)
    jg_ = jg.PoseGraph(**{k: jnp.asarray(v) for k, v in arrays.items()})
    g_j, chi_j = js.optimize_hier(jg_, jcfg)
    g = tg.PoseGraph(**{k: torch.tensor(v) for k, v in arrays.items()})
    ts.optimize_hier.stages = dict.fromkeys(ts.optimize_hier.stages, 0)
    g_t, chi_t = ts.optimize_hier(g, to_port(jcfg))
    assert ts.optimize_hier.stages == {"dense": 2, "vcycle": 2, "polish": 2}
    assert _pose_diff(g_t.poses.numpy(), g_j.poses) < 2e-3
    assert _xy_err(g_t.poses, gt) < _xy_err(est, gt) / 100.0
    assert abs(float(chi_t) - float(chi_j)) < 1e-3


def test_coarse_graph_matches_jax():
    """The anchor graph of the 1024-node serpentine: the same edge list,
    mask and counts, poses, measurements and information as JAX's
    `_coarse_graph` (bit for bit on this graph)."""
    arrays, _, _, jcfg = _serpentine(1024, 30)
    jg_ = jg.PoseGraph(**{k: jnp.asarray(v) for k, v in arrays.items()})
    stride = jcfg.sparse_coarse_stride
    want = jax.jit(lambda g: js._coarse_graph(g, jcfg, stride,
                                              jcfg.sparse_max_loops)[0])(jg_)
    g = tg.PoseGraph(**{k: torch.tensor(v) for k, v in arrays.items()})
    cfg = to_port(jcfg)
    plan = ts.sparse_plan(g, cfg, CPU, hier=True)
    got, ccfg = ts._coarse_graph(g, cfg, plan.levels[0])
    assert ccfg.max_nodes == 64 and ccfg.max_edges == 63 + 128
    for field in got._fields:
        a, b = getattr(got, field).numpy(), np.asarray(getattr(want, field))
        assert a.shape == b.shape, field
        np.testing.assert_allclose(a.astype(np.float64), b, rtol=0,
                                   atol=1e-6, err_msg=field)


def test_plan_from_host_graph_equals_plan_from_device_graph():
    """sparse_plan from a HostGraph (no device read) routes as the plan
    read back from the PoseGraph it copies to (two levels: 64 slots, 8
    anchors at hier_dense_max 16)."""
    cfg = to_port(GraphConfig(max_nodes=64, max_edges=256, gn_iters=10,
                              sparse_coarse_stride=8, sparse_max_loops=8,
                              hier_dense_max=16))
    host = tg.HostGraph(cfg)
    for k in range(40):
        host.add_node(np.array([float(k), 0.0, 0.0]))
        if k:
            host.add_edge(k - 1, k, np.array([1.0, 0.0, 0.0]),
                          np.eye(3) * 100.0)
    host.add_edge(3, 35, np.array([32.0, 0.0, 0.0]), np.eye(3) * 400.0)
    a = ts.sparse_plan(host, cfg, CPU, hier=True)
    b = ts.sparse_plan(host.to_device(CPU), cfg, CPU, hier=True)
    assert len(a.levels) == len(b.levels) == 2
    for la, lb in zip(a.levels, b.levels):
        for x, y in zip(la, lb):
            if isinstance(x, torch.Tensor):
                assert torch.equal(x, y)
            elif x is not None and hasattr(x, "_fields"):
                for u, v in zip(x, y):
                    assert (torch.equal(u, v) if isinstance(u, torch.Tensor)
                            else u == v)
            else:
                assert x == y


def test_coarse_graph_stride_divides_n_nodes():
    """tests/test_sparse_graph.py's regression: with n_nodes a multiple of
    the stride and spare capacity, the anchor graph activates exactly the
    chain edges between live anchors, and the straight chain solves
    exactly."""
    cfg = to_port(GraphConfig(max_nodes=64, max_edges=256, gn_iters=10,
                              sparse_coarse_stride=8, sparse_max_loops=8))
    host = tg.HostGraph(cfg)
    for k in range(32):
        host.add_node(np.array([float(k), 0.0, 0.0]))
        if k:
            host.add_edge(k - 1, k, np.array([1.0, 0.0, 0.0]),
                          np.eye(3) * 100.0)
    g = host.to_device(CPU)
    plan = ts.sparse_plan(host, cfg, CPU, hier=True)
    gc, _ = ts._coarse_graph(g, cfg, plan.levels[0])
    em = gc.edge_mask.numpy()
    assert em[:7].sum() == 3, em[:7]
    g2, chi = ts.optimize_hier(g, cfg, plan=plan)
    want = np.stack([np.arange(32, dtype=np.float64), np.zeros(32),
                     np.zeros(32)], axis=1)
    np.testing.assert_allclose(g2.poses[:32].numpy(), want, atol=1e-3)
    assert float(chi) < 1e-4
