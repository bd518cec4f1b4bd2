#!/usr/bin/env python3
"""Endurance run of the PyTorch port on one NVIDIA GPU, the twin of
scripts/bench_endurance.py: full SLAM with the Schur pose-graph solver
over the long synthetic endurance log (Intel-Research-Lab statistics: 4
laps of a 28 m ring corridor at 3 cm a scan, 13,337 scans, 180 beams).

    python3 scripts/bench_endurance_torch.py
    python3 scripts/bench_endurance_torch.py --device cpu --scans 64   (tests)

Config (bench_endurance.py's): a bounded 768^2 grid at 0.05 m, 256 ray
samples, bench.py's matcher, chunk 64, match_min_motion 0.25;
GraphConfig(max_nodes=1024, max_edges=4096, keyframe_dist=0.8,
loop_min_gap=30, loop_radius=3.0, loop_score_accept=0.35,
loop_max_correction_xy=2.5, gn_iters=10, robust_kind="dcs");
run_full_slam(optimizer="schur"). The log is endurance_log(laps=4,
step=0.03, seed=0); `--scans N` keeps its first N scans.

Prints one JSON line: scans/s (the host clock and CUDA events), seconds,
loops, keyframes, keyframe ATE unaligned and aligned (and odometry's at
the same scans), whether the trajectory is finite, peak RSS and peak
device memory, host reads a scan, the card's name and power limit, and
the gate of scripts/tpu_smoke.py's endurance stage (aligned kf ATE <
0.8 m, unaligned < 3.8 m, at least 10 loops, a finite trajectory) with
its verdict. Exits 1 when the gate fails. The JAX package's run on its
TPU gave 0.444 m aligned, 0.76 m unaligned, 53 loops, 496 keyframes.
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from slam2d_tpu_torch.config import (  # noqa: E402
    FrontendConfig,
    GraphConfig,
    GridConfig,
    MatcherConfig,
    SensorConfig,
)
from slam2d_tpu_torch.data.synth import endurance_log  # noqa: E402
from slam2d_tpu_torch.metrics import ate_rmse  # noqa: E402
from slam2d_tpu_torch.run import bench_configs  # noqa: E402
from slam2d_tpu_torch.run.full_slam import fetch, run_full_slam  # noqa: E402

SPAN = 28.0
GATE = dict(aligned_m=0.8, unaligned_m=3.8, min_loops=10)


def endurance_config():
    """(cfg, graph_cfg) of scripts/bench_endurance.py."""
    cfg = FrontendConfig(
        sensor=SensorConfig(n_beams=180, max_range=12.0),
        grid=GridConfig(height=768, width=768, resolution=0.05,
                        ray_samples=256, center_x=SPAN / 2,
                        center_y=SPAN / 2),
        matcher=MatcherConfig(search_xy=0.3, search_theta=0.15, n_theta=13),
        chunk=64, match_min_motion=0.25,
    )
    gcfg = GraphConfig(
        max_nodes=1024, max_edges=4096, keyframe_dist=0.8,
        loop_min_gap=30, loop_radius=3.0, loop_score_accept=0.35,
        loop_max_correction_xy=2.5, gn_iters=10, robust_kind="dcs",
    )
    return cfg, gcfg


def rss_mb() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--scans", type=int, default=None,
                    help="keep the log's first N scans")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    cuda = device.type == "cuda"
    if cuda and not torch.cuda.is_available():
        raise SystemExit("bench_endurance_torch.py: no CUDA device")
    cfg, gcfg = endurance_config()
    _, log = endurance_log(cfg.sensor, span=SPAN, laps=4, step=0.03, seed=0)
    if args.scans is not None:
        log = {k: v[: args.scans] for k, v in log.items()}
    T = len(log["odom"])
    gt = log["gt_poses"]

    # the kernels' build, cuSOLVER's set-up and the first chunk, untimed
    warm = {k: v[: cfg.chunk] for k, v in log.items()}
    run_full_slam(warm, cfg, gcfg, optimizer="schur", device=device)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
    fetch.reads = 0
    t0 = time.perf_counter()
    res = run_full_slam(log, cfg, gcfg, optimizer="schur", device=device)
    if cuda:
        end.record()
        end.synchronize()
    sec = time.perf_counter() - t0
    idx = np.asarray(res.kf_scan_idx, int)
    kf_gt = gt[idx]
    out = dict(
        metric="endurance_full_slam_scans_per_sec", value=T / sec,
        unit="scans/s", scans=T, wall_s=sec,
        scans_per_sec_cuda_events=(
            T / (start.elapsed_time(end) / 1e3) if cuda else None),
        n_loops=int(res.n_loops), n_keyframes=len(idx),
        kf_ate=ate_rmse(res.kf_poses, kf_gt, align=False),
        odom_kf_ate=ate_rmse(log["odom"][idx], kf_gt, align=False),
        kf_ate_aligned=ate_rmse(res.kf_poses, kf_gt, align=True),
        odom_kf_ate_aligned=ate_rmse(log["odom"][idx], kf_gt, align=True),
        traj_ate=ate_rmse(res.traj, gt, align=False),
        traj_finite=bool(np.isfinite(res.traj).all()),
        host_reads_per_scan=fetch.reads / T,
        rss_mb_peak=rss_mb(),
        device_memory_peak_bytes=(
            torch.cuda.max_memory_allocated(device) if cuda else None),
        device=bench_configs.card() if cuda else "cpu",
        optimizer="schur", gate=GATE,
    )
    out["gate_pass"] = bool(
        out["kf_ate_aligned"] < GATE["aligned_m"]
        and out["kf_ate"] < GATE["unaligned_m"]
        and out["n_loops"] >= GATE["min_loops"] and out["traj_finite"]
    )
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    sys.exit(0 if main()["gate_pass"] else 1)
