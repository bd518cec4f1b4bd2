#!/usr/bin/env python3
"""The JAX package's pose-graph solvers against keyframe count, as the
reference that chip_smoke.py's phase 24 holds the port's solver table
(scripts/bench_graph_scale_torch.py) to.

    python3 scripts/graph_scale_reference.py [--sizes 512 ... 16384] [--out PATH]

Runs scripts/bench_graph_scale.py's table with the JAX package on the
CPU: for K in (512, 1024, 2048, 4096, 16384), the serpentine corridor
graph of tests/test_sparse_graph.py (`_serpentine_graph(K, max(10, K //
34), drift=0.01)`, sparse_max_loops 128), solved by the dense
`optimize` (K <= 2048), `optimize_schur(n_blocks=8)` (K <= 4096) and
`optimize_hier`. Writes, for each K and solver, the trajectory error
(RMS of the xy error against the ground truth), chi2 and whether the
poses are finite, or the exception's name where the solve raised, and
err0, the error before the solve, into scripts/graph_scale_reference
.json; and under `runs` the same for the graph with the x of every node
but the anchor moved by k float32 ulps, k in bench_configs.GRAPH_ULPS
(-2..2; k = 0 is the graph itself): a float32 solve's error on these
graphs is a draw of its rounding (one ulp moves the dense and Schur
errors by up to 60x), so chip_smoke.py holds the port's five against
these five. `seconds` is a call's on this CPU (the first call of a
solver at each K includes its tracing): a note of where the file came
from, not a figure of any accelerator (~25 min in all on 8 CPU cores,
~6 GB at 16384).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
DEFAULT_OUT = os.path.join(ROOT, "scripts", "graph_scale_reference.json")


def reference(sizes, out: str):
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=1").strip()
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from slam2d_tpu.graph.schur import optimize_schur
    from slam2d_tpu.graph.se2_graph import PoseGraph, optimize
    from slam2d_tpu.graph.sparse import optimize_hier
    from scripts.bench_graph_scale_torch import solvers_at, xy_err
    from slam2d_tpu_torch.run.bench_configs import GRAPH_ULPS, ulp_moved
    from tests.test_sparse_graph import _serpentine_graph

    fns = {
        "dense": optimize,
        "schur": lambda g_, c_: optimize_schur(g_, c_, n_blocks=8),
        "hier": optimize_hier,
    }
    result = dict(jax=dict(version=jax.__version__,
                           backend=jax.default_backend()),
                  graph="tests/test_sparse_graph.py:_serpentine_graph(K, "
                        "max(10, K // 34), drift=0.01), sparse_max_loops 128",
                  sizes={})
    for K in sizes:
        n_loops = max(10, K // 34)
        g, gt, est, cfg = _serpentine_graph(K, n_loops=n_loops, drift=0.01)
        cfg = dataclasses.replace(cfg, sparse_max_loops=128)
        arrays = {k: np.asarray(v) for k, v in g._asdict().items()}
        row = dict(K=K, loops=n_loops, err0=xy_err(est, gt),
                   ulps=list(GRAPH_ULPS))
        for name in solvers_at(K):
            runs = []
            for k in GRAPH_ULPS:
                gk = PoseGraph(**{f: jnp.asarray(v) for f, v in
                                  ulp_moved(arrays, k).items()})
                t0 = time.perf_counter()
                try:
                    g2, chi = fns[name](gk, cfg)
                    poses = np.asarray(g2.poses)
                except Exception as e:  # noqa: BLE001 — record, keep going
                    runs.append(dict(ulps=k, failed=type(e).__name__,
                                     seconds=time.perf_counter() - t0))
                    continue
                runs.append(dict(ulps=k, err_m=xy_err(poses, gt),
                                 chi2=float(chi),
                                 finite=bool(np.isfinite(poses).all()),
                                 seconds=time.perf_counter() - t0))
            row[name] = dict(runs[GRAPH_ULPS.index(0)], runs=runs)
            del row[name]["ulps"]
        result["sizes"][str(K)] = row
        print(json.dumps(row), flush=True)
    with open(out, "w") as f:
        json.dump(result, f, indent=1)
        f.write("\n")
    print(f"wrote {out}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sizes", type=int, nargs="+",
                    default=[512, 1024, 2048, 4096, 16384])
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args()
    reference(args.sizes, args.out)


if __name__ == "__main__":
    main()
