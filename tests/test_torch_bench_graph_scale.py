"""scripts/bench_graph_scale_torch.py, the PyTorch port's twin of
scripts/bench_graph_scale.py: its graphs are the script's
(tests/test_sparse_graph.py's `_serpentine_graph(K, max(10, K // 34),
drift=0.01)`, array for array), the port's three solvers match the JAX
package's on the script's smallest graph (K = 512) within the tolerances
that the parity tests state: Schur test_torch_schur.py's (5e-3 m / rad,
chi2 1e-3 relative), the hierarchical solver test_torch_sparse_graph.py's
on the 1024-node serpentine (2e-3, chi2 1e-3); the dense solve the same
serpentine tolerance, 2e-3 (test_torch_graph.py's 1e-4 holds graphs of a
few nodes; a [1536, 1536] float32 Cholesky of the 512-node chain lands
both packages at the float32 noise floor: 5.8e-5 and 3.3e-4 m from the
truth, 5.3e-4 m apart), its chi2 test_torch_graph.py's 1e-4 relative.
Its CPU test mode prints the `device=` line and rows with the script's
keys. The dense solve's factor, core/numerics.cholesky_f32, is LAPACK's
float32 factor on the CPU and, by the route the card takes, the float64
factor rounded to float32."""

import dataclasses
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam2d_tpu.graph import schur as jschur
from slam2d_tpu.graph import se2_graph as jg
from slam2d_tpu.graph import sparse as jsparse
from slam2d_tpu_torch.graph import se2_graph as tg
from test_sparse_graph import _serpentine_graph
from torch_parity import pose_error, to_port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import bench_graph_scale_torch as bgs  # noqa: E402

torch.set_num_threads(1)

# (pose tolerance m / rad, chi2 tolerance: (rtol, atol)) of each solver's
# parity test
TOLS = {"dense": (2e-3, (1e-4, 1e-6)), "schur": (5e-3, (1e-3, 1e-6)),
        "hier": (2e-3, (0.0, 1e-3))}
JAX_SOLVERS = {
    "dense": jg.optimize,
    "schur": lambda g, c: jschur.optimize_schur(g, c, n_blocks=8),
    "hier": jsparse.optimize_hier,
}


def _jax_graph(K):
    g, gt, est, cfg = _serpentine_graph(K, n_loops=max(10, K // 34),
                                        drift=0.01)
    return g, gt, est, dataclasses.replace(cfg, sparse_max_loops=128)


@pytest.mark.parametrize("K", [512, 1024])
def test_graph_is_the_scripts(K):
    arrays, gt, est, cfg, n_loops = bgs.scale_graph(K)
    g, jgt, jest, jcfg = _jax_graph(K)
    assert n_loops == max(10, K // 34)
    assert cfg == to_port(jcfg)
    for name in tg.PoseGraph._fields:
        np.testing.assert_array_equal(np.asarray(arrays[name]),
                                      np.asarray(getattr(g, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(gt, jgt)
    np.testing.assert_array_equal(est, jest)


@pytest.mark.parametrize("solver", ["dense", "schur", "hier"])
def test_solvers_match_jax_at_512(solver):
    arrays, gt, est, cfg, _ = bgs.scale_graph(512)
    g = tg.PoseGraph(**{k: torch.as_tensor(v) for k, v in arrays.items()})
    jgraph = jg.PoseGraph(**{k: jnp.asarray(v) for k, v in arrays.items()})
    jcfg = _jax_graph(512)[3]
    out, chi = bgs.SOLVERS[solver](g, cfg)
    ref, chi_ref = JAX_SOLVERS[solver](jgraph, jcfg)
    p, pj = out.poses.numpy(), np.asarray(ref.poses)
    assert np.isfinite(p).all()
    dxy, dth = pose_error(p, pj)
    tol, (rtol, atol) = TOLS[solver]
    print(f"{solver}: max |dxy| {dxy:.3g} m, |dtheta| {dth:.3g} rad; err "
          f"{bgs.xy_err(p, gt):.3g} against JAX's {bgs.xy_err(pj, gt):.3g}, "
          f"odometry's {bgs.xy_err(est, gt):.3g}")
    assert dxy <= tol and dth <= tol
    np.testing.assert_allclose(float(chi), float(chi_ref), rtol=rtol,
                               atol=atol)
    assert bgs.xy_err(p, gt) < bgs.xy_err(est, gt) / 5.0


def test_solvers_at_drops_as_the_script():
    assert bgs.solvers_at(2048) == ["dense", "schur", "hier"]
    assert bgs.solvers_at(4096) == ["schur", "hier"]
    assert bgs.solvers_at(16384) == ["hier"]


def test_cpu_mode_prints_the_table():
    out = subprocess.run(
        [sys.executable, "scripts/bench_graph_scale_torch.py", "--device",
         "cpu", "--sizes", "128", "256"],
        capture_output=True, text=True, timeout=600, cwd=ROOT,
        env=dict(os.environ, OMP_NUM_THREADS="2"),
    )
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert lines[0] == "device=cpu"
    rows = [json.loads(x) for x in lines[1:]]
    assert [r["K"] for r in rows] == [128, 256]
    keys = {"K", "loops", "err0"} | {f"{s}_{k}" for s in bgs.SOLVERS
                                     for k in ("ms", "err")}
    for r in rows:
        assert set(r) == keys and r["loops"] == 10
        for s in bgs.SOLVERS:
            assert r[f"{s}_ms"] > 0 and r[f"{s}_err"] < r["err0"] / 5.0


@pytest.mark.parametrize("route", ["cpu", "cuda"])
def test_cholesky_f32_on_the_serpentines_normal_matrix(route):
    """core/numerics.cholesky_f32 on the dense solve's matrix at K = 512
    (scripts/dense_factor_probe_torch.py's): the CPU route is LAPACK's
    float32 factor, the JAX package's, bit for bit; the route the card
    takes (cholesky_via_f64) is the float64 factor rounded to float32,
    nearer the float64 factor than LAPACK's float32 one."""
    import dense_factor_probe_torch as probe
    from slam2d_tpu_torch.core.numerics import cholesky_f32, cholesky_via_f64

    arrays, _, _, cfg, _ = bgs.scale_graph(512)
    g = tg.PoseGraph(**{k: torch.as_tensor(v) for k, v in arrays.items()})
    Hd = probe.normal_matrix(g, cfg, 512)
    L, info = (cholesky_f32 if route == "cpu" else cholesky_via_f64)(Hd)
    L32, info32 = torch.linalg.cholesky_ex(Hd)
    L64 = torch.linalg.cholesky(Hd.double())
    assert L.dtype == torch.float32 and int(info) == int(info32) == 0
    if route == "cpu":
        assert torch.equal(L, L32)
        return
    assert torch.equal(L, L64.float())
    err = float((L.double() - L64).abs().max())
    err32 = float((L32.double() - L64).abs().max())
    print(f"max |L - L64|: rounded float64 {err:.3g}, LAPACK float32 "
          f"{err32:.3g}")
    assert err < err32
