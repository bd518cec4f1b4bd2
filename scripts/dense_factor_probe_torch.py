#!/usr/bin/env python3
"""The dense pose-graph solve's float32 Cholesky factor on one NVIDIA GPU:
cuSOLVER's single-matrix float32 factor against LAPACK's (the JAX
package's CPU factor) and against the port's `core/numerics.cholesky_f32`
(on CUDA the float64 factor rounded to float32).

    python3 scripts/dense_factor_probe_torch.py [--sizes 512 1024 2048]

For each K, on scripts/bench_graph_scale_torch.py's serpentine graph:
(1) the damped, anchored normal matrix of the first Gauss-Newton
iteration (se2_graph._gn_iterate's), factored by torch.linalg.cholesky_ex
on the card (cuSOLVER potrf), by the same call on the host (LAPACK
spotrf) and by cholesky_f32, each factor's largest error against the
float64 factor relative to its largest entry, and the card's milliseconds
a factor (CUDA events, 10 back to back after one); (2) se2_graph.optimize
on the card with cuSOLVER's float32 factor and with cholesky_f32, over
the graph with every node's x but the anchor's moved by k float32 ulps,
k in bench_configs.GRAPH_ULPS: the trajectory errors (RMS xy error
against the ground truth, m). Prints the card's name and power limit,
then one JSON line a K. Raises without a card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from unittest import mock

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from bench_graph_scale_torch import scale_graph, xy_err  # noqa: E402
from slam2d_tpu_torch.core.numerics import cholesky_f32  # noqa: E402
from slam2d_tpu_torch.graph import se2_graph  # noqa: E402
from slam2d_tpu_torch.run import bench_configs  # noqa: E402


def _ms(fn, n: int = 10) -> float:
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def normal_matrix(g, cfg, K: int):
    """_gn_iterate's damped, anchored matrix at the graph's poses."""
    H, _, _ = se2_graph.assemble_normal_eq(
        g.poses, g.edges_ij, g.edges_z, g.edges_omega, g.edge_mask, K,
        se2_graph._robust_of(cfg, 0))
    diag = torch.zeros(3 * K, dtype=torch.float32, device=H.device)
    diag[:3] = 1e8
    diag = diag + cfg.damping + (~g.node_mask).repeat_interleave(3).float()
    return 0.5 * (H + H.T) + torch.diag(diag)


def probe(K: int, dev: torch.device) -> dict:
    arrays, gt, _, cfg, _ = scale_graph(K)

    def graph(a):
        return se2_graph.PoseGraph(**{k: torch.as_tensor(v, device=dev)
                                      for k, v in a.items()})

    Hd = normal_matrix(graph(arrays), cfg, K)
    L64 = torch.linalg.cholesky(Hd.double()).cpu()
    scale = float(L64.abs().max())
    forms = {
        "cusolver_f32": lambda: torch.linalg.cholesky_ex(Hd)[0],
        "cholesky_f32": lambda: cholesky_f32(Hd)[0],
    }
    row = {"K": K, "rows": 3 * K}
    for name, fn in forms.items():
        L = fn().cpu().double()
        row[f"{name}_rel_err"] = float((L - L64).abs().max()) / scale
        row[f"{name}_ms"] = _ms(fn)
    L = torch.linalg.cholesky_ex(Hd.cpu())[0].double()
    row["lapack_f32_rel_err"] = float((L - L64).abs().max()) / scale

    def errs():
        out = []
        for k in bench_configs.GRAPH_ULPS:
            g2, _ = se2_graph.optimize(
                graph(bench_configs.ulp_moved(arrays, k)), cfg)
            out.append(xy_err(g2.poses.cpu().numpy(), gt))
        return out

    row["ulps"] = list(bench_configs.GRAPH_ULPS)
    row["optimize_err_m_cholesky_f32"] = errs()
    with mock.patch.object(se2_graph, "cholesky_f32",
                           torch.linalg.cholesky_ex):
        row["optimize_err_m_cusolver_f32"] = errs()
    return row


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sizes", type=int, nargs="+", default=[512, 1024, 2048])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("dense_factor_probe_torch.py: no CUDA device")
    print(bench_configs.card(), flush=True)
    dev = torch.device("cuda", 0)
    for K in args.sizes:
        print(json.dumps(probe(K, dev)), flush=True)


if __name__ == "__main__":
    main()
