"""PyTorch port: the block Schur-complement solver (graph/schur.py)
against the JAX package's on the same numpy graphs (CPU).

The graphs are tests/test_graph.py's square loop and
tests/test_robust_edges.py's false-loop graph. Held: `build_plan` array
for array (from a PoseGraph and from the HostGraph); each block's
assembled H_bb, H_bs, H_ss, b_b, b_s within 2e-5 of each array's largest
entry (tests/test_torch_graph.py's block tolerance; the port's Jacobians
are closed-form, the JAX package's from jax.jacfwd); `optimize_schur`'s
poses within 5e-3 m / rad of the JAX package's and of the port's dense
solver (tests/test_schur.py's tolerance; measured ~5e-6) and its chi2
within 1e-3 relative; a failed factorization giving NaN where the JAX
package's does.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam2d_tpu.config import GraphConfig
from slam2d_tpu.graph import schur as js
from slam2d_tpu_torch.graph import schur as ts
from slam2d_tpu_torch.graph import se2_graph as tg
from test_graph import _square_loop_graph
from test_robust_edges import _with_false_loop
from torch_parity import pose_error, to_port

torch.set_num_threads(1)

POSE_TOL = 5e-3
BLOCK_RTOL = 2e-5
CFG = GraphConfig(max_nodes=64, max_edges=128, gn_iters=15)
DCS_GNC = dataclasses.replace(CFG, robust_kind="dcs", robust_delta=3.0,
                              robust_gnc_iters=2)


def _graphs():
    loop, _, _ = _square_loop_graph(drift=0.15)
    return {"loop": loop, "false_loop": _with_false_loop(loop)}


def _port(g) -> tg.PoseGraph:
    return tg.PoseGraph(*(torch.tensor(np.array(x)) for x in g))


def _host(g) -> tg.HostGraph:
    return tg.HostGraph.from_arrays(to_port(CFG), _port(g))


@pytest.mark.parametrize("graph", ["loop", "false_loop"])
@pytest.mark.parametrize("n_blocks", [1, 2, 4])
def test_build_plan_matches_jax(graph, n_blocks):
    g = _graphs()[graph]
    ref = js.build_plan(g, n_blocks)
    for out in (ts.build_plan(_port(g), n_blocks),
                ts.build_plan(_host(g), n_blocks)):
        assert out._fields == ref._fields
        for name, a, b in zip(ref._fields, out, ref):
            np.testing.assert_array_equal(a, b, err_msg=name)


def test_build_plan_refuses_an_empty_graph():
    with pytest.raises(ValueError, match="non-empty"):
        ts.build_plan(tg.HostGraph(to_port(CFG)), 4)
    empty = tg.graph_init(to_port(CFG), "cpu")
    out, chi = ts.optimize_schur(empty, to_port(CFG))
    assert out is empty and float(chi) == 0.0


@pytest.mark.parametrize("graph, cfg", [("loop", CFG),
                                        ("false_loop", DCS_GNC)])
@pytest.mark.parametrize("n_blocks", [2, 4])
def test_block_assembly_matches_jax(graph, cfg, n_blocks):
    """Every block's normal-equation pieces at the initial poses, with the
    robust kernel at GNC iteration 0, against the JAX package's
    _block_assemble of each block."""
    g = _graphs()[graph]
    plan = js.build_plan(g, n_blocks)
    plan_dev, _, _, _ = js._plan_device_arrays(plan)
    I, S = plan.int_ids.shape[1], plan.n_sep
    delta = js._host_delta_eff(cfg, 0)
    assert ts._host_delta_eff(to_port(cfg), 0) == delta
    robust = None if cfg.robust_kind == "none" else (
        cfg.robust_kind, jnp.float32(delta))
    pg = _port(g)
    pt = ts.schur_tables(ts.build_plan(pg, n_blocks), "cpu")
    out = ts._assemble(pg.poses, pg, pt, I, S, None if robust is None else (
        cfg.robust_kind, np.float32(delta)))
    chi_ref = 0.0
    for b in range(n_blocks):
        ref = js._block_assemble(g.poses, g, tuple(a[b] for a in plan_dev),
                                 I, S, robust)
        for k, name in enumerate(("Hbb", "Hbs", "Hss", "bb", "bs")):
            r = np.asarray(ref[k])
            scale = max(float(np.abs(r).max()), 1e-30)
            np.testing.assert_allclose(out[k][b].numpy(), r, rtol=0,
                                       atol=BLOCK_RTOL * scale,
                                       err_msg=f"block {b} {name}")
        chi_ref += float(ref[5])
    np.testing.assert_allclose(float(out[5]), chi_ref, rtol=BLOCK_RTOL)


CASES = [("loop", CFG, 2), ("loop", CFG, 4), ("false_loop", DCS_GNC, 4),
         ("false_loop", DCS_GNC, 2)]


@pytest.mark.parametrize("graph, cfg, n_blocks", CASES,
                         ids=["loop-2", "loop-4", "false_loop-dcs_gnc-4",
                              "false_loop-dcs_gnc-2"])
def test_optimize_schur_matches_jax_and_dense(graph, cfg, n_blocks):
    """tests/test_schur.py's square loop (n_blocks 2 and 4) and
    tests/test_robust_edges.py's robust case (DCS with GNC, a false loop
    edge): against the JAX package's optimize_schur and the port's dense
    optimize; the plan from the HostGraph gives the same poses."""
    g = _graphs()[graph]
    ref, chi_ref = js.optimize_schur(g, cfg, n_blocks=n_blocks)
    pcfg = to_port(cfg)
    pg = _port(g)
    out, chi = ts.optimize_schur(pg, pcfg, n_blocks)
    dense, _ = tg.optimize(pg, pcfg)
    n = int(g.n_nodes)
    p = out.poses[:n].numpy()
    assert np.isfinite(p).all()
    for name, other in (("JAX", np.asarray(ref.poses[:n])),
                        ("dense", dense.poses[:n].numpy())):
        dxy, dth = pose_error(p, other)
        print(f"against {name}: max |dxy| {dxy:.3g} m, |dtheta| {dth:.3g}")
        assert dxy <= POSE_TOL and dth <= POSE_TOL
    np.testing.assert_allclose(float(chi), float(chi_ref), rtol=1e-3,
                               atol=1e-6)
    # the unused slots stay where they were
    np.testing.assert_array_equal(out.poses[n:].numpy(),
                                  np.asarray(g.poses[n:]))
    planned, chi2 = ts.optimize_schur(
        pg, pcfg, n_blocks, plan=ts.build_plan(_host(g), n_blocks))
    assert torch.equal(planned.poses, out.poses) and torch.equal(chi2, chi)


def test_failed_factorization_gives_nan_as_jax():
    """Negative damping: no block is positive definite. Both packages give
    NaN at the same poses (every active node), and neither raises."""
    g, _, _ = _square_loop_graph(drift=0.15)
    cfg = dataclasses.replace(CFG, damping=-1e9, gn_iters=1)
    ref, _ = js.optimize_schur(g, cfg, n_blocks=4)
    out, _ = ts.optimize_schur(_port(g), to_port(cfg), 4)
    nan_ref = np.isnan(np.asarray(ref.poses))
    assert nan_ref[: int(g.n_nodes)].all()
    np.testing.assert_array_equal(torch.isnan(out.poses).numpy(), nan_ref)


def test_schur_keeps_full_float32_products(monkeypatch):
    """The iteration sets "highest" float32 matmul precision for its
    products and restores the caller's afterwards."""
    g, _, _ = _square_loop_graph(drift=0.15)
    seen = []
    orig = ts._iteration_core_f32

    def spy(*a, **k):
        seen.append(torch.get_float32_matmul_precision())
        return orig(*a, **k)

    monkeypatch.setattr(ts, "_iteration_core_f32", spy)
    prev = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("medium")
        ts.optimize_schur(_port(g), to_port(CFG), 4)
        assert seen and set(seen) == {"highest"}
        assert torch.get_float32_matmul_precision() == "medium"
    finally:
        torch.set_float32_matmul_precision(prev)


@pytest.mark.parametrize("n_blocks", [2, 4])
def test_reused_tables_give_the_same_solve(n_blocks):
    """`tables=schur_tables(plan)` built once and passed to two solves on
    the same plan: the same bits as a solve that builds its own."""
    g = _graphs()["false_loop"]
    pcfg = to_port(DCS_GNC)
    pg = _port(g)
    plan = ts.build_plan(_host(g), n_blocks)
    tables = ts.schur_tables(plan, pg.poses.device)
    ref, chi_ref = ts.optimize_schur(pg, pcfg, n_blocks, plan=plan)
    for _ in range(2):
        out, chi = ts.optimize_schur(pg, pcfg, n_blocks, plan=plan,
                                     tables=tables)
        assert torch.equal(out.poses, ref.poses) and torch.equal(chi, chi_ref)
