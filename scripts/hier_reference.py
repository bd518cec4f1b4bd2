#!/usr/bin/env python3
"""The JAX package's hierarchical pose-graph solver on the serpentine
graph, as the reference that chip_smoke.py's phase 19 holds the port to.

    python3 scripts/hier_reference.py [--nodes 4096 16384] [--out PATH]

Runs `slam2d_tpu.graph.sparse.optimize_hier` on the CPU on the serpentine
corridor graph of tests/test_sparse_graph.py (64-node passes, odometry
drift 0.01, one rung closure per ~34 nodes: 120 loop edges at 4096
nodes, scaled with the node count; sparse_max_loops 128), built by
`bench_configs.hier_bench_graph` from the port's numpy copy of that
test's graph, and writes for each size the trajectory error (RMS of
the xy error against the ground truth) before and after, chi2 and the
seconds of the call (the first call includes tracing) into
scripts/hier_reference.json (~1 min at 4096, ~5 min at 16384, ~6 GB).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
DEFAULT_OUT = os.path.join(ROOT, "scripts", "hier_reference.json")


def xy_err(poses, gt) -> float:
    p = np.asarray(poses, np.float64)
    return float(np.sqrt(np.mean(np.sum((p[:, :2] - gt[:, :2]) ** 2, 1))))


def reference(sizes, out: str):
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=1").strip()
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    from slam2d_tpu.config import GraphConfig
    from slam2d_tpu.graph.se2_graph import PoseGraph
    from slam2d_tpu.graph.sparse import optimize_hier
    from slam2d_tpu_torch.run.bench_configs import hier_bench_graph

    result = dict(jax=dict(version=jax.__version__,
                           backend=jax.default_backend()),
                  graph="bench_configs.hier_bench_graph(K)",
                  sizes={})
    for K in sizes:
        arrays, gt, est, ckw = hier_bench_graph(K)
        cfg = GraphConfig(**ckw)
        g = PoseGraph(**{k: jnp.asarray(v) for k, v in arrays.items()})
        t0 = time.perf_counter()
        g2, chi = optimize_hier(g, cfg)
        poses = np.asarray(g2.poses)
        seconds = time.perf_counter() - t0
        result["sizes"][str(K)] = dict(
            nodes=K, loops=int(arrays["n_edges"]) - (K - 1),
            err_before_m=xy_err(est, gt), err_m=xy_err(poses, gt),
            chi2=float(chi), finite=bool(np.isfinite(poses).all()),
            seconds=seconds,
        )
        print(json.dumps({str(K): result["sizes"][str(K)]}), flush=True)
    with open(out, "w") as f:
        json.dump(result, f, indent=1)
        f.write("\n")
    print(f"wrote {out}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nodes", type=int, nargs="+", default=[4096, 16384])
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args()
    reference(args.nodes, args.out)


if __name__ == "__main__":
    main()
