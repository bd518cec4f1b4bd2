#!/usr/bin/env python3
"""Config-5 (full SLAM) throughput of the PyTorch port with repeated loop
closures, with and without the incremental post-loop map rebuild, on one
NVIDIA GPU: the twin of scripts/bench_fullslam.py.

    python3 scripts/bench_fullslam_torch.py [--variant incremental|full_rebuild|both] [--seed 3]
    python3 scripts/bench_fullslam_torch.py --device cpu --scans 64 --variant both   (tests)

Scenario, as the script builds it: `run_full_slam_tiled` at
`bench_configs.fullslam_script_config()` (256^2 tiles at 0.1 m, 48
slots; 180 beams to 12 m, 128 ray samples; search 0.3 m / 0.15 rad with
13 thetas, chunk 32, bootstrap 2.0 m; the graph at 512 nodes and 2048
edges, keyframes every 1 m, loop gap 20, radius 3 m, accept score 0.35,
corrections up to 2.5 m, 10 Gauss-Newton iterations) over
`bench_configs.fullslam_bench_log` (two laps of the box-rooms tour, the
second re-entering the first's territory throughout, so the loop
detector fires repeatedly and every accepted loop rebuilds the map: 715
scans at seed 3). The map update is update_impl "auto": kernel 1
`hybrid`, with kernels 2 and 3 in the matcher. The variants:

- incremental: `incremental_rebuild=True` (IncrementalTiledRebuilder
  replaying from a cached prefix of the keyframes whose rendered pose
  did not move by a quarter cell);
- full_rebuild: `incremental_rebuild=False` (eps 0: every keyframe whose
  pose moved at all is integrated again, each accept).

Each variant is run once whole (the warm run: kernels built, the chunk
graph captured, cuSOLVER set up), then timed by the host clock from the
call to the keyframe poses on the host. `--device cpu` runs no warm run,
with `--scans` to cut the log.

Prints one JSON line a variant with the script's keys (`variant`,
`scans`, `scans_per_sec`, `wall_s`, `n_loops`, `loop_attempts`,
`kf_ate_m` unaligned against the ground truth at the keyframes, m,
`session_calibration`: bench_torch.py's) and `device`, the card's name
and power limit as `nvidia-smi --query-gpu=name,power.limit
--format=csv,noheader` gives them ({"name": "cpu", ...} on the CPU).
Numbers are unrounded. `--device cuda` (the default) raises without a
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

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from slam2d_tpu_torch.metrics import ate_rmse  # noqa: E402
from slam2d_tpu_torch.run import bench_configs  # noqa: E402
from slam2d_tpu_torch.run.full_slam_tiled import run_full_slam_tiled  # noqa: E402

VARIANTS = {"incremental": True, "full_rebuild": False}


def script_log(sensor, seed: int = 3, scans: int | None = None) -> dict:
    """fullslam_bench_log of `seed`, its first `scans` scans where given."""
    log = bench_configs.fullslam_bench_log(sensor, seed=seed)
    if scans is None:
        return log
    return {k: np.asarray(v)[:scans] for k, v in log.items()}


def bench_fullslam(variant: str, seed: int = 3, device="cuda",
                   scans: int | None = None, before_run=None):
    """One variant (module docstring) on `device`: on CUDA the warm run,
    then the timed run. `before_run()`, where given, is called just
    before the timed run (a caller's counters start there). Returns (the
    JSON line's dict, the timed run's FullSLAMResult, the log)."""
    dev = torch.device(device)
    on_cuda = dev.type == "cuda"
    if on_cuda and dev.index is None:
        dev = torch.device("cuda", 0)
    inc = VARIANTS[variant]
    cfg, tcfg, gcfg = bench_configs.fullslam_script_config()
    log = script_log(cfg.sensor, seed, scans)
    T = len(log["odom"])

    def run():
        return run_full_slam_tiled(log, cfg, tcfg, gcfg,
                                   incremental_rebuild=inc, device=dev)

    if on_cuda:
        run()
        torch.cuda.synchronize(dev)
    if before_run is not None:
        before_run()
    t0 = time.perf_counter()
    res = run()
    kf = np.asarray(res.kf_poses)
    dt = time.perf_counter() - t0
    if not np.isfinite(res.traj).all():
        raise AssertionError(f"{variant}: the trajectory is not finite")
    gt = np.asarray(log["gt_poses"])
    from bench_torch import session_calibration

    card = {"name": "cpu", "power_limit": None}
    if on_cuda:
        name, limit = (x.strip() for x in bench_configs.card().split(","))
        card = {"name": name, "power_limit": limit}
    line = {
        "variant": variant,
        "scans": T,
        "scans_per_sec": T / dt,
        "wall_s": dt,
        "n_loops": int(res.n_loops),
        "loop_attempts": len(res.loop_attempts),
        "kf_ate_m": float(ate_rmse(kf, gt[np.asarray(res.kf_scan_idx, int)],
                                   align=False)),
        "session_calibration": session_calibration(dev),
        "device": card,
    }
    return line, res, log


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=3)
    ap.add_argument("--variant", choices=[*VARIANTS, "both"], default="both")
    ap.add_argument("--scans", type=int, default=None,
                    help="the log's first N scans (default: all)")
    args = ap.parse_args(argv)
    if (torch.device(args.device).type == "cuda"
            and not torch.cuda.is_available()):
        raise SystemExit("bench_fullslam_torch.py: no CUDA device (pass "
                         "--device cpu for the CPU test mode)")
    variants = list(VARIANTS) if args.variant == "both" else [args.variant]
    for variant in variants:
        line, _, _ = bench_fullslam(variant, args.seed, args.device,
                                    args.scans)
        print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
