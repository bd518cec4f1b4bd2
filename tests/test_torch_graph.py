"""PyTorch port: the pose graph (core/se2.error_se2, graph/se2_graph)
against the JAX package's on the same numpy graphs (CPU).

Tolerances: error_se2 and the residuals 1e-5 absolute (float32 rounding
of cos/sin); the per-edge blocks and the normal equations 2e-5 relative
to each array's largest entry (the port's Jacobians are closed-form, the
JAX package's come from jax.jacfwd; they agree to ~3e-6); optimize's
poses 1e-4 m and rad after 15 Gauss-Newton iterations (measured ~1e-6)
and its chi2 1e-4 relative.
"""


import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam2d_tpu.config import GraphConfig
from slam2d_tpu.core import se2 as jse2
from slam2d_tpu.graph import se2_graph as jg
from slam2d_tpu_torch.core import se2 as tse2
from slam2d_tpu_torch.graph import se2_graph as tg
from test_graph import _square_loop_graph
from test_robust_edges import _cold_start_line, _with_false_loop
from torch_parity import to_port

torch.set_num_threads(1)

CPU = torch.device("cpu")
POSE_TOL = 1e-4
BLOCK_RTOL = 2e-5


def _cfg(**kw):
    return GraphConfig(**{"max_nodes": 64, "max_edges": 128, "gn_iters": 15,
                          **kw})


def _port(g) -> tg.PoseGraph:
    """The port's PoseGraph of a JAX PoseGraph (numpy copies)."""
    return tg.PoseGraph(*(torch.tensor(np.array(x)) for x in g))


def _random_graph(seed=0, n=24):
    """A graph with random poses, chain and loop edges and random SPD
    information matrices, as a JAX PoseGraph."""
    rng = np.random.default_rng(seed)
    g = jg.graph_init(_cfg())
    poses = rng.uniform(-5.0, 5.0, (n, 3)).astype(np.float32)
    poses[:, 2] = rng.uniform(-3.1, 3.1, n)
    for p in poses:
        g = jg.add_node(g, jnp.asarray(p))
    pairs = [(k, k + 1) for k in range(n - 1)] + [(n - 1, 0), (3, 17), (20, 5)]
    for i, j in pairs:
        z = rng.normal(0.0, 1.0, 3).astype(np.float32)
        a = rng.normal(0.0, 1.0, (3, 3))
        omega = (a @ a.T + 3.0 * np.eye(3)).astype(np.float32) * 20.0
        g = jg.add_edge(g, i, j, jnp.asarray(z), jnp.asarray(omega))
    return g


def _close(a, b, rtol=BLOCK_RTOL):
    a, b = np.asarray(a), np.asarray(b)
    scale = max(float(np.abs(b).max()), 1e-30)
    np.testing.assert_allclose(a, b, rtol=0, atol=rtol * scale)


def test_error_se2_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.uniform(-10.0, 10.0, (3, 200, 3)).astype(np.float32)
    x[..., 2] = rng.uniform(-np.pi, np.pi, (3, 200))
    ref = np.asarray(jse2.error_se2(*(jnp.asarray(a) for a in x)))
    out = tse2.error_se2(*(torch.tensor(a) for a in x)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)
    g = _random_graph()
    ref = np.asarray(jg.edge_residuals(g.poses, g.edges_ij, g.edges_z))
    pg = _port(g)
    out = tg.edge_residuals(pg.poses, pg.edges_ij, pg.edges_z).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


ROBUST = {
    "none": {},
    "huber": dict(robust_kind="huber", robust_delta=3.0, robust_gnc_iters=0),
    "dcs": dict(robust_kind="dcs", robust_delta=3.0, robust_gnc_iters=0),
    "dcs_gnc": dict(robust_kind="dcs", robust_delta=3.0, robust_gnc_iters=2),
}


@pytest.mark.parametrize("kind", list(ROBUST))
@pytest.mark.parametrize("it", [0, 1, 2, None])
def test_edge_blocks_match_jax(kind, it):
    """Per-edge blocks with each robust kernel, at every GNC iteration
    (the threshold annealed 100x, 10x, then fully robust) and at the
    'final' delta."""
    cfg = _cfg(**ROBUST[kind])
    g = _random_graph(2)
    robust_j = jg._robust_of(cfg, None if it is None else jnp.int32(it))
    robust_t = tg._robust_of(to_port(cfg), it)
    if robust_j is None:
        assert robust_t is None
    else:
        assert robust_t[0] == robust_j[0]
        assert float(robust_t[1]) == float(robust_j[1])
    ref = jg._edge_blocks(g.poses, g.edges_ij, g.edges_z, g.edges_omega,
                          g.edge_mask, robust_j)
    pg = _port(g)
    out = tg._edge_blocks(pg.poses, pg.edges_ij, pg.edges_z, pg.edges_omega,
                          pg.edge_mask, robust_t)
    for a, b in zip(out, ref):
        _close(a.numpy(), b)


def test_normal_equations_and_edge_chi2s_match_jax():
    g = _random_graph(3)
    K = g.poses.shape[0]
    pg = _port(g)
    for kind in ("none", "dcs_gnc"):
        cfg = _cfg(**ROBUST[kind])
        H, b, chi = jg.assemble_normal_eq(
            g.poses, g.edges_ij, g.edges_z, g.edges_omega, g.edge_mask, K,
            jg._robust_of(cfg, jnp.int32(0)),
        )
        Ht, bt, chit = tg.assemble_normal_eq(
            pg.poses, pg.edges_ij, pg.edges_z, pg.edges_omega, pg.edge_mask,
            K, tg._robust_of(to_port(cfg), 0),
        )
        _close(Ht.numpy(), H)
        _close(bt.numpy(), b)
        np.testing.assert_allclose(float(chit), float(chi), rtol=BLOCK_RTOL)
    _close(tg.edge_chi2s(pg.poses, pg).numpy(), jg.edge_chi2s(g.poses, g))


def _graphs():
    loop, _, _ = _square_loop_graph(drift=0.15)
    cold, _ = _cold_start_line(drift_per=0.5)
    return {"loop": loop, "false_loop": _with_false_loop(loop), "cold": cold}


CASES = [
    ("loop", {}),
    ("loop", ROBUST["dcs_gnc"]),
    ("false_loop", {}),
    ("false_loop", ROBUST["dcs_gnc"]),
    ("false_loop", ROBUST["huber"]),
    ("cold", dict(robust_kind="dcs", robust_delta=3.0, robust_gnc_iters=0)),
    ("cold", dict(robust_kind="dcs", robust_delta=3.0, robust_gnc_iters=5)),
    ("loop", ROBUST["huber"]),
]


@pytest.mark.parametrize("graph, kw", CASES,
                         ids=[f"{g}-{kw.get('robust_kind', 'none')}-"
                              f"gnc{kw.get('robust_gnc_iters', 2)}"
                              for g, kw in CASES])
def test_optimize_matches_jax(graph, kw):
    """tests/test_graph.py's loop graph and tests/test_robust_edges.py's
    false-edge and cold-start graphs, plain, with DCS (and GNC) and with
    Huber."""
    g = _graphs()[graph]
    cfg = _cfg(**kw)
    ref, chi = jg.optimize(g, cfg)
    out, chit = tg.optimize(_port(g), to_port(cfg))
    n = int(g.n_nodes)
    p_ref = np.asarray(ref.poses[:n])
    p_out = out.poses[:n].numpy()
    assert np.isfinite(p_out).all()
    np.testing.assert_allclose(p_out[:, :2], p_ref[:, :2], rtol=0,
                               atol=POSE_TOL)
    dth = np.angle(np.exp(1j * (p_out[:, 2] - p_ref[:, 2])))
    assert np.abs(dth).max() <= POSE_TOL
    np.testing.assert_allclose(float(chit), float(chi), rtol=1e-4, atol=1e-6)
    # the unused slots stay where they were
    np.testing.assert_array_equal(out.poses[n:].numpy(),
                                  np.asarray(g.poses[n:]))


def test_failed_factorization_gives_nan_as_jax():
    """A normal matrix that is not positive definite (negative damping):
    both packages give NaN poses, and neither raises."""
    g, _, _ = _square_loop_graph(drift=0.15)
    cfg = _cfg(damping=-1e9, gn_iters=1)
    ref, _ = jg.optimize(g, cfg)
    out, _ = tg.optimize(_port(g), to_port(cfg))
    assert np.isnan(np.asarray(ref.poses)).all()
    assert torch.isnan(out.poses).all()


def test_host_graph_round_trip_and_device_adds():
    """HostGraph: nodes and edges as JAX's HostGraph stores them; its
    to_device graph through from_arrays (tensors and numpy) gives the same
    arrays; add_node / add_edge on a device graph equal the host ones and
    leave their input unchanged."""
    cfg = _cfg()
    hj, ht = jg.HostGraph(cfg), tg.HostGraph(to_port(cfg))
    dev = tg.graph_init(to_port(cfg), CPU)
    rng = np.random.default_rng(4)
    for k in range(6):
        p = rng.normal(0.0, 2.0, 3).astype(np.float32)
        assert ht.add_node(p) == hj.add_node(p) == k
        dev = tg.add_node(dev, p)
    empty = tg.graph_init(to_port(cfg), CPU)
    for k in range(5):
        z = rng.normal(0.0, 1.0, 3).astype(np.float32)
        om = np.eye(3, dtype=np.float32) * (k + 1.0)
        assert ht.add_edge(k, k + 1, z, om) == hj.add_edge(k, k + 1, z, om)
        dev = tg.add_edge(dev, k, k + 1, z, om)
    ref = hj.to_device()
    g = ht.to_device(CPU)
    for a, b, c in zip(g, ref, dev):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        np.testing.assert_array_equal(c.numpy(), np.asarray(b))
    assert g.n_nodes.dtype == torch.int32 and int(g.n_edges) == 5
    assert not empty.node_mask.any() and int(empty.n_nodes) == 0
    for src in (g, tg.PoseGraph(*(x.numpy() for x in g))):
        back = tg.HostGraph.from_arrays(to_port(cfg), src).to_device(CPU)
        for a, b in zip(back, g):
            assert torch.equal(a, b)
    poses = rng.normal(0.0, 1.0, (6, 3)).astype(np.float32)
    ht.set_poses(poses)
    hj.set_poses(poses)
    np.testing.assert_array_equal(ht.poses, hj.poses)
