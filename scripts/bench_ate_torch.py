#!/usr/bin/env python3
"""Frontend ATE and throughput of the PyTorch port at scripts/bench_ate.py's
config, on one NVIDIA GPU: the twin of scripts/bench_ate.py, for the
frontend's accuracy on any seed of the bench log.

    python3 scripts/bench_ate_torch.py [impl] [seed] [fine_theta_bins] [score_impl]
    python3 scripts/bench_ate_torch.py auto 0 2 auto --device cpu --scans 64   (tests)

The positional arguments are bench_ate.py's: `impl` the GridConfig
update_impl ("auto" resolves as on the accelerator: the hybrid update),
`seed` the log's noise seed, `fine_theta_bins` the matcher's fine-pass
theta restriction (-1: all), `score_impl` the matcher's scorer. The
one-hot matmul scorers "mxu" and "mxu_int8" (a TPU workaround) raise.

Config, as bench_ate.py builds it: a 1024^2 grid at 0.05 m, 180 beams to
12 m, n_theta 13, search_xy 0.3 m, search_theta 0.15, chunk 64,
match_min_motion 0.25; the box-rooms world of 20 m and its ten waypoints,
0.05 m steps, the log's first T = (len // 64) * 64 scans.

On CUDA the frontend runs as run_frontend runs it there, one CUDA graph
replay a chunk: the chunk graph is built on the first chunk, then the
whole log is run once through the entry point and timed by the host
clock (`scans_per_sec` = T over that run's seconds). `--device cpu` runs
the eager loop, with `--scans` to cut the log.

Prints one JSON line with bench_ate.py's keys (`impl`, `seed`,
`fine_theta_bins`, `backend`, `scans_per_sec`, `ate_slam_m`,
`ate_odom_m`, unaligned ATEs in m), `backend` the card's name (or "cpu")
and, beside it, `power_limit` as `nvidia-smi
--query-gpu=name,power.limit --format=csv,noheader` prints it, and
`scans`.
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

from slam2d_tpu_torch.config import (  # noqa: E402
    FrontendConfig,
    GridConfig,
    MatcherConfig,
    SensorConfig,
)
from slam2d_tpu_torch.data.synth import SynthWorld, simulate_log  # noqa: E402
from slam2d_tpu_torch.match.correlative import resolve_score_impl  # noqa: E402
from slam2d_tpu_torch.metrics import ate_rmse  # noqa: E402
from slam2d_tpu_torch.run import bench_configs  # noqa: E402
from slam2d_tpu_torch.run.frontend import run_frontend  # noqa: E402

WAYPOINTS = [[3.0, 3.0], [3.0, 8.0], [8.0, 8.0], [12.0, 3.5], [16.0, 3.5],
             [17.0, 9.0], [12.0, 14.0], [9.0, 17.0], [4.0, 16.0], [3.0, 4.0]]


def config(impl: str = "auto", fine_theta_bins: int = 2,
           score_impl: str = "auto") -> FrontendConfig:
    """bench_ate.py's FrontendConfig; raises NotImplementedError for the
    scorers the port does not carry."""
    resolve_score_impl(score_impl)
    return FrontendConfig(
        sensor=SensorConfig(n_beams=180, max_range=12.0),
        grid=GridConfig(
            height=1024, width=1024, resolution=0.05, ray_samples=256,
            center_x=10.0, center_y=10.0, update_impl=impl,
        ),
        matcher=MatcherConfig(search_xy=0.3, search_theta=0.15, n_theta=13,
                              fine_theta_bins=fine_theta_bins,
                              score_impl=score_impl),
        chunk=64,
        match_min_motion=0.25,
    )


def bench_ate_log(cfg: FrontendConfig, seed: int, scans: int | None = None):
    """bench_ate.py's log of `seed`, its first (len // chunk) * chunk scans
    (or its first `scans`)."""
    log = simulate_log(SynthWorld.box_rooms(20.0), np.array(WAYPOINTS),
                       cfg.sensor, step=0.05, seed=seed)
    T = (len(log["odom"]) // cfg.chunk) * cfg.chunk
    if scans is not None:
        T = min(T, scans)
    return {k: np.asarray(v)[:T] for k, v in log.items()}


def bench_ate(impl: str = "auto", seed: int = 0, fine_theta_bins: int = 2,
              score_impl: str = "auto", device="cuda",
              scans: int | None = None, before_run=None) -> dict:
    """One run of the frontend over bench_ate.py's log of `seed` on
    `device` (module docstring); returns the JSON line's dict.
    `before_run()`, where given, is called just before the timed run
    (after the chunk graph's build): a caller's counters start there."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", 0)
    cfg = config(impl, fine_theta_bins, score_impl)
    log = bench_ate_log(cfg, seed, scans)
    T = len(log["odom"])
    on_cuda = dev.type == "cuda"
    if on_cuda:
        # the chunk graph, built on the first chunk
        run_frontend({k: v[: cfg.chunk] for k, v in log.items()}, cfg, dev)
        torch.cuda.synchronize(dev)
    if before_run is not None:
        before_run()
    t0 = time.perf_counter()
    _, traj, _ = run_frontend(log, cfg, dev)
    seconds = time.perf_counter() - t0
    if not np.isfinite(traj).all():
        raise AssertionError("the trajectory is not finite")
    backend, limit = "cpu", None
    if on_cuda:
        backend, limit = (x.strip() for x in bench_configs.card().split(","))
    return {
        "impl": impl, "seed": seed, "fine_theta_bins": fine_theta_bins,
        "backend": backend, "power_limit": limit,
        "scans_per_sec": T / seconds,
        "ate_slam_m": float(ate_rmse(traj, log["gt_poses"], align=False)),
        "ate_odom_m": float(ate_rmse(log["odom"], log["gt_poses"],
                                     align=False)),
        "scans": T,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("impl", nargs="?", default="auto")
    ap.add_argument("seed", nargs="?", type=int, default=0)
    ap.add_argument("fine_theta_bins", nargs="?", type=int, default=2)
    ap.add_argument("score_impl", nargs="?", default="auto")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--scans", type=int, default=None,
                    help="the log's first N scans (default: all)")
    args = ap.parse_args(argv)
    if (torch.device(args.device).type == "cuda"
            and not torch.cuda.is_available()):
        raise SystemExit("bench_ate_torch.py: no CUDA device (pass --device "
                         "cpu for the CPU test mode)")
    print(json.dumps(bench_ate(args.impl, args.seed, args.fine_theta_bins,
                               args.score_impl, args.device, args.scans)),
          flush=True)


if __name__ == "__main__":
    main()
