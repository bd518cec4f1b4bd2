#!/usr/bin/env python3
"""Benchmark of the PyTorch port: frontend scan-matching throughput
(scans/s) on one NVIDIA GPU, the twin of bench.py.

    python3 bench_torch.py [--repeats 5]
    python3 bench_torch.py --device cpu --scans 40 --repeats 1   (tests)

Workload: bench.py's, from slam2d_tpu_torch/run/bench_configs.py
(bench_config, bench_log): a 1024^2 grid at 0.05 m, 180 beams, n_theta
13, search_xy 0.3 m, chunk 64, the seed-0 synthetic log of 1078 scans.

On CUDA the frontend runs as run_frontend runs it there: one CUDA graph
replay a chunk of 64 scans, nothing read back to the host until the
trajectory's one fetch. First the chunk graph is built (warm-up steps on
a side stream, the kernels' build, the capture; reported apart as
`capture_s`) and a chunk run to warm up. Each rate is then the median
over `--repeats` whole runs of the log through the entry point (its
state init, the log's staging in pinned memory, the replays, the final
fetch), timed by the host clock and, beside it, by CUDA events; the runs'
rates are printed with it (they move between calls: PERF.md §5).

Prints one JSON line last, with bench.py's keys:
- `metric`, `value` (the graph path's median scans/s), `unit`,
  `vs_baseline` (value over `reference_scans_per_sec`);
- `reference_scans_per_sec`: tests/numpy_reference.py's NumpyRefSLAM at
  the same workload shape on this host's CPU, timed as bench.py times it;
- `offline_scans_per_sec`: run_frontend_offline, median;
- `eager_scans_per_sec`: the same device-gated steps enqueued one by one
  (run_frontend(graph=False)), median;
- `host_reads_per_scan` (frontend_step.host_syncs over a graph run),
  `ate_m` (unaligned, the graph run's), `update_impl`, `score_impl`,
  `fine_theta_bins`;
- `session_calibration`: a 1024^2 bf16 matmul in µs by CUDA events and
  the round trip of a blocking one-element read in ms;
- `device`: the card's name and power limit as `nvidia-smi
  --query-gpu=name,power.limit --format=csv,noheader` prints them.

It runs on CUDA and raises without a card; `--device cpu` (with a short
`--scans`) exists for the tests: it runs the eager loop, and its numbers
are CPU numbers (the device keys say so and the calibration is null).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import numpy as np
import torch

from slam2d_tpu_torch.grid.occupancy import resolve_update_impl
from slam2d_tpu_torch.match.correlative import resolve_score_impl
from slam2d_tpu_torch.metrics import ate_rmse
from slam2d_tpu_torch.run import bench_configs
from slam2d_tpu_torch.run.frontend import (
    chunk_graph,
    frontend_step,
    run_frontend,
    run_frontend_offline,
)

ROOT = os.path.dirname(os.path.abspath(__file__))


def reference_scans_per_sec(log, n_prime: int = 30, n_time: int = 3):
    """bench.py's comparator: NumpyRefSLAM at the bench workload shape,
    `n_prime` updates, then `n_time` matched and integrated scans timed."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from numpy_reference import NumpyRefSLAM

    ref = NumpyRefSLAM(
        size=1024, resolution=0.05, center=(10.0, 10.0),
        n_beams=180, max_range=12.0,
        search_xy=0.3, search_step=0.05,
        search_theta=0.15, theta_step=0.025,
    )
    odom = np.asarray(log["odom"])
    ranges = np.asarray(log["ranges"])
    n_prime = min(n_prime, len(odom) - n_time)
    for t in range(n_prime):
        ref.update(odom[t], ranges[t])
    t0 = time.perf_counter()
    for t in range(n_prime, n_prime + n_time):
        p, _ = ref.match(odom[t], ranges[t])
        ref.update(p, ranges[t])
    return n_time / (time.perf_counter() - t0)


def session_calibration(dev) -> dict:
    """A 1024^2 bf16 matmul in µs (CUDA events, median of 5 timings of 20
    back to back) and a blocking one-element read in ms (median of 15)."""
    if dev.type != "cuda":
        return {"device": "cpu", "matmul_1024_bf16_us": None,
                "sync_rtt_ms": None}
    a = torch.ones((1024, 1024), dtype=torch.bfloat16, device=dev)
    for _ in range(3):
        a @ a
    times = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(20):
            a @ a
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) * 1e3 / 20)
    x = torch.zeros((), device=dev)
    rtts = []
    for _ in range(15):
        t0 = time.perf_counter()
        (x + 1).item()
        rtts.append((time.perf_counter() - t0) * 1e3)
    return {"device": torch.cuda.get_device_name(dev),
            "matmul_1024_bf16_us": statistics.median(times),
            "sync_rtt_ms": statistics.median(rtts)}


def timed(fn, repeats: int, dev):
    """(the last result, host seconds a run, CUDA-event seconds a run)."""
    walls, events = [], []
    result = None
    for _ in range(repeats):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        result = fn()
        walls.append(time.perf_counter() - t0)
        if dev.type == "cuda":
            end.record()
            end.synchronize()
            events.append(start.elapsed_time(end) / 1e3)
    return result, walls, events


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--scans", type=int, default=None,
                    help="the log's first N scans (default: all 1078)")
    ap.add_argument("--repeats", type=int, default=5)
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("bench_torch.py: no CUDA device (pass --device cpu "
                         "for the CPU test mode)")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", 0)
    cfg = bench_configs.bench_config()
    log = bench_configs.bench_log(cfg.sensor)
    if args.scans is not None:
        log = {k: np.asarray(v)[: args.scans] for k, v in log.items()}
    T = len(log["odom"])
    K = cfg.chunk
    on_cuda = dev.type == "cuda"

    capture_s = None
    if on_cuda:
        t0 = time.perf_counter()
        chunk_graph(cfg, dev, K)
        torch.cuda.synchronize(dev)
        capture_s = time.perf_counter() - t0
    warm = {k: np.asarray(v)[:K] for k, v in log.items()}
    run_frontend(warm, cfg, dev)
    run_frontend(warm, cfg, dev, graph=False)

    frontend_step.host_syncs = 0
    (_, traj, _), walls, events = timed(
        lambda: run_frontend(log, cfg, dev), args.repeats, dev)
    host_reads = frontend_step.host_syncs / (args.repeats * T)
    (_, traj_eager, _), e_walls, _ = timed(
        lambda: run_frontend(log, cfg, dev, graph=False), args.repeats, dev)
    (_, traj_off, _), o_walls, _ = timed(
        lambda: run_frontend_offline(log, cfg, dev), args.repeats, dev)
    if not np.array_equal(traj_off, traj):
        raise AssertionError("offline and streaming trajectories differ")
    if not np.array_equal(traj_eager, traj):
        raise AssertionError("graph and eager trajectories differ")
    if not np.isfinite(traj).all():
        raise AssertionError("the trajectory is not finite")

    rates = [T / w for w in walls]
    value = statistics.median(rates)
    ref = reference_scans_per_sec(log)
    device = {"name": "cpu", "power_limit": None}
    if on_cuda:
        name, limit = (x.strip() for x in bench_configs.card().split(","))
        device = {"name": name, "power_limit": limit}
    print(json.dumps({
        "metric": "frontend_scans_per_sec",
        "value": value,
        "unit": "scans/s",
        "vs_baseline": value / ref,
        "mode": "cuda_graph" if on_cuda else "eager_cpu",
        "scans": T,
        "repeats": args.repeats,
        "scans_per_sec_runs": rates,
        "cuda_event_scans_per_sec": (
            statistics.median(T / e for e in events) if events else None),
        "capture_s": capture_s,
        "offline_scans_per_sec": statistics.median(T / w for w in o_walls),
        "eager_scans_per_sec": statistics.median(T / w for w in e_walls),
        "eager_scans_per_sec_runs": [T / w for w in e_walls],
        "reference_scans_per_sec": ref,
        "host_reads_per_scan": host_reads,
        "ate_m": float(ate_rmse(traj, log["gt_poses"], align=False)),
        "update_impl": resolve_update_impl(cfg.grid, cfg.sensor, "frontend"),
        "score_impl": resolve_score_impl(cfg.matcher.score_impl),
        "fine_theta_bins": cfg.matcher.fine_theta_bins,
        "session_calibration": session_calibration(dev),
        "device": device,
    }))


if __name__ == "__main__":
    main()
