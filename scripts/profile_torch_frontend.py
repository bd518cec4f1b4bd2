#!/usr/bin/env python3
"""Where the time goes in the PyTorch frontend on one GPU.

    python3 scripts/profile_torch_frontend.py [--scans 256] [--out profile_out]

Runs the port (slam2d_tpu_torch) at bench.py's config and log: a warmup
over the first `--scans` scans, then a torch.profiler trace (CPU and CUDA
activities) of the next `--scans` scans. Prints the kernels by device
time, the device busy share of the traced wall time, and per-scan host
time, and writes the gzipped Chrome trace to `--out`. Needs a CUDA
device.
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

import chip_smoke  # noqa: E402  (bench config and log)
from slam2d_tpu_torch.run.frontend import (  # noqa: E402
    frontend_init,
    frontend_step,
)


def _busy_us(events) -> float:
    """Union of the device kernels' [start, end) intervals, in us."""
    spans = sorted(
        (e.time_range.start, e.time_range.end) for e in events
        if e.device_type == torch.autograd.DeviceType.CUDA
    )
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scans", type=int, default=256)
    ap.add_argument("--out", default="profile_out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_frontend.py needs a CUDA device")
    dev = torch.device("cuda", 0)
    cfg = chip_smoke.bench_config()
    log = chip_smoke.bench_log(cfg.sensor)
    odom = torch.as_tensor(log["odom"], device=dev)
    ranges = torch.as_tensor(log["ranges"], device=dev)
    n = args.scans
    state = frontend_init(cfg, dev, start_pose=log["odom"][0],
                          start_odom=log["odom"][0])
    for k in range(n):
        state, _ = frontend_step(state, odom[k], ranges[k], cfg)
    torch.cuda.synchronize()

    frontend_step.matches = frontend_step.updates = 0
    frontend_step.host_syncs = 0
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for k in range(n, 2 * n):
            state, _ = frontend_step(state, odom[k], ranges[k], cfg)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.events()
    busy = _busy_us(events)
    print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=25))
    kernels = {}
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CUDA:
            k = kernels.setdefault(e.name, [0, 0.0])
            k[0] += 1
            k[1] += e.time_range.end - e.time_range.start
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])
    summary = dict(
        card=chip_smoke._card(), scans=n, wall_ms=wall_us / 1e3,
        us_per_scan=wall_us / n, device_busy_us=busy,
        device_busy_share=busy / wall_us, device_kernels=sum(
            v[0] for v in kernels.values()),
        matches=frontend_step.matches, updates=frontend_step.updates,
        host_syncs=frontend_step.host_syncs,
        top_kernels=[dict(name=k[:90], launches=v[0], us=v[1])
                     for k, v in top[:12]],
    )
    print(json.dumps(summary))
    os.makedirs(args.out, exist_ok=True)
    prof.export_chrome_trace(
        os.path.join(args.out, "torch_frontend_trace.json.gz")
    )


if __name__ == "__main__":
    main()
