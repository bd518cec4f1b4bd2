#!/usr/bin/env python3
"""Pose-graph solver wall time against keyframe count, of the PyTorch port
on one NVIDIA GPU: the twin of scripts/bench_graph_scale.py.

    python3 scripts/bench_graph_scale_torch.py
    python3 scripts/bench_graph_scale_torch.py --device cpu --sizes 128 256   (tests)

For K in (512, 1024, 2048, 4096, 16384), the serpentine corridor graph
of tests/test_sparse_graph.py (`bench_configs.serpentine_graph_arrays(K,
max(10, K // 34), drift=0.01)`: 64-node passes, one rung closure per ~34
nodes, sparse_max_loops 128) is solved by the dense `optimize` (a [3K,
3K] Cholesky; K <= 2048), `optimize_schur(n_blocks=8)` (K <= 4096) and
`optimize_hier`, as the script does. Each solver is timed as the
script's `time_opt`: one call, then the mean of 3 calls, each call
ending when the poses are read to the host (the plans that the Schur
and hierarchical solvers build from the graph included). TF32 stays
off, as PyTorch leaves it.

Prints `device=<name, power limit>` (as `nvidia-smi
--query-gpu=name,power.limit --format=csv,noheader`; `device=cpu` on the
CPU), then one JSON row a K with the script's keys: `K`, `loops`,
`err0` (RMS of the xy error against the ground truth before the solve,
m), `<solver>_ms` and `<solver>_err` (after it, m), unrounded. A solve
that raises prints `"<solver>_ms": "failed: <Exception>"`, as the
script's table does. `--device cuda` (the default) raises without a
card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from slam2d_tpu_torch.config import GraphConfig  # noqa: E402
from slam2d_tpu_torch.graph.schur import optimize_schur  # noqa: E402
from slam2d_tpu_torch.graph.se2_graph import PoseGraph, optimize  # noqa: E402
from slam2d_tpu_torch.graph.sparse import optimize_hier  # noqa: E402
from slam2d_tpu_torch.run import bench_configs  # noqa: E402

SIZES = (512, 1024, 2048, 4096, 16384)
SOLVERS = {
    "dense": optimize,
    "schur": lambda g, cfg: optimize_schur(g, cfg, n_blocks=8),
    "hier": optimize_hier,
}


def solvers_at(K: int) -> list[str]:
    """The script's solvers at K: the dense solve to 2048 nodes (151 MB of
    H at 4096, its float32 accuracy collapsed), Schur to 4096."""
    names = list(SOLVERS)
    if K > 2048:
        names.remove("dense")
    if K > 4096:
        names.remove("schur")
    return names


def xy_err(poses, gt) -> float:
    p = np.asarray(poses, np.float64)
    return float(np.sqrt(np.mean(np.sum((p[:, :2] - gt[:, :2]) ** 2, 1))))


def scale_graph(K: int):
    """(arrays, gt, est, GraphConfig, n_loops): the script's graph at K."""
    n_loops = max(10, K // 34)
    arrays, gt, est, ckw = bench_configs.serpentine_graph_arrays(
        K, n_loops, drift=0.01)
    return arrays, gt, est, GraphConfig(**ckw, sparse_max_loops=128), n_loops


def time_opt(fn, g, cfg, reps: int = 3, warm: bool = True):
    """The script's time_opt: one call (with `warm`), then the mean
    seconds of `reps` calls, each ending when the poses are on the host.
    Returns (seconds, host poses, chi2)."""
    if warm:
        fn(g, cfg)[0].poses.cpu()
    t0 = time.perf_counter()
    for _ in range(reps):
        out, chi = fn(g, cfg)
        poses = out.poses.cpu().numpy()
    return (time.perf_counter() - t0) / reps, poses, float(chi)


def table(device="cuda", sizes=SIZES, reps: int = 3, on_row=None,
          first=None):
    """The solver table on `device`: a list of rows (module docstring's
    keys, plus `<solver>_chi2` and `<solver>_finite` beside them for the
    caller's checks). `on_row(row)`, where given, sees each row as it is
    made. `first(K, name, arrays, cfg)`, where given, is called before
    each solver is timed at K, in place of the first, untimed call: it
    is to run that solver on graphs of the same shapes (the caller's own
    runs)."""
    dev = torch.device(device)
    rows = []
    for K in sizes:
        arrays, gt, est, cfg, n_loops = scale_graph(K)
        g = PoseGraph(**{k: torch.as_tensor(v, device=dev)
                         for k, v in arrays.items()})
        row = {"K": K, "loops": n_loops, "err0": xy_err(est, gt)}
        for name in solvers_at(K):
            try:
                if first is not None:
                    first(K, name, arrays, cfg)
                dt, poses, chi = time_opt(SOLVERS[name], g, cfg, reps,
                                          warm=first is None)
            except Exception as e:  # noqa: BLE001 — record, keep the table
                row[name + "_ms"] = f"failed: {type(e).__name__}"
                continue
            row[name + "_ms"] = dt * 1e3
            row[name + "_err"] = xy_err(poses, gt)
            row[name + "_chi2"] = chi
            row[name + "_finite"] = bool(np.isfinite(poses).all())
        rows.append(row)
        if on_row is not None:
            on_row(row)
    return rows


def script_row(row: dict) -> dict:
    """A row with the script's keys alone."""
    return {k: v for k, v in row.items()
            if not k.endswith(("_chi2", "_finite"))}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--sizes", type=int, nargs="+", default=list(SIZES))
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("bench_graph_scale_torch.py: no CUDA device "
                             "(pass --device cpu for the CPU test mode)")
        print(f"device={bench_configs.card()}", flush=True)
    else:
        print("device=cpu", flush=True)
    table(dev, args.sizes,
          on_row=lambda row: print(json.dumps(script_row(row)), flush=True))


if __name__ == "__main__":
    main()
