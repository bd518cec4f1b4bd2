#!/usr/bin/env python3
"""Benchmark of the PyTorch port: FastSLAM throughput (scans/s) on one
NVIDIA GPU, the twin of bench_pf.py.

    python3 bench_pf_torch.py [--particles 100] [--ungated] [--repeats 5]
    python3 bench_pf_torch.py --device cpu --scans 64 --repeats 1   (tests)

Workload: bench_pf.py's, built from the same flags with the same
defaults: FastSLAM-100 on bf16 512^2 maps at 0.1 m, 180 beams, chunk 32,
the seed-0 synthetic log of 653 scans (run/bench_configs.py:
pf_bench_log). The flags pass into the port's FrontendConfig and
PFConfig as bench_pf.py passes them into the JAX package's. Flags whose
settings the port does not carry raise, naming ROADMAP.md's "Not ported
on purpose": --refine-chunk other than 0 (a TPU memory knob),
--fuse-light-prefix (the JAX package's dispatch fusion) and the shared
update's diagnostics that pf/shared_update.py:check_production_mode
refuses.

The strategy resolves as the JAX package's run_fastslam resolves it:
host-gated from PFConfig.host_gate_min_particles (512) particles on, else
the device-gated steps, on CUDA one CUDA graph replay a chunk.
`--ungated` forces the device-gated form (bench_pf.py's flag of the same
name). On CUDA the chunk graph is built first (its warm-up steps, the
kernels' build, the capture: `capture_s`), then one whole run warms up,
and the rate is the median over `--repeats` whole runs of
run_fastslam (its state init, the log's staging, the steps, the one
fetch), timed by the host clock; each run's rate is in `runs`.

Prints one JSON line last with bench_pf.py's keys (`metric`
fastslam{P}_scans_per_sec, `value`, `unit`, `vs_baseline` against
bench_pf.py's 1.0 scans/s reference, `ate_m`, `ate_odom_m`,
`session_calibration`) and `device` (the card's name and power limit as
`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` prints
them), `host_gated`, `host_reads_per_scan`, `capture_s`, `runs`, `scans`,
`repeats`. It raises without a card; `--device cpu` (with a short
`--scans`) exists for the tests, and its keys say its numbers are the
CPU's.
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

from slam2d_tpu_torch.config import (
    FrontendConfig,
    GridConfig,
    MatcherConfig,
    PFConfig,
    SensorConfig,
)
from slam2d_tpu_torch.metrics import ate_rmse
from slam2d_tpu_torch.pf.fastslam import fastslam_step
from slam2d_tpu_torch.pf.shared_update import check_production_mode
from slam2d_tpu_torch.run import bench_configs
from slam2d_tpu_torch.run.fastslam_run import pf_chunk_graph, run_fastslam

ROOT = os.path.dirname(os.path.abspath(__file__))
REFERENCE_SCANS_PER_SEC = 1.0   # bench_pf.py's


def build_parser():
    """bench_pf.py's flags, with its defaults, and the port's own."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--particles", type=int, default=100)
    ap.add_argument("--map-dtype", default="bfloat16")
    ap.add_argument("--refine-chunk", type=int, default=0)
    ap.add_argument("--update-impl", default="auto")
    ap.add_argument("--update-mode", default="auto")
    ap.add_argument("--update-theta-slots", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0, help="PF RNG seed")
    ap.add_argument("--resolution", type=float, default=0.1)
    ap.add_argument("--grid", type=int, default=512)
    ap.add_argument("--match-min-motion", type=float, default=None)
    ap.add_argument("--update-subcell", type=int, default=1)
    ap.add_argument("--update-bilinear", action="store_true")
    ap.add_argument("--fuse-light-prefix", type=int, default=None)
    ap.add_argument("--images-f32", action="store_true")
    ap.add_argument("--carve-shrink", type=float, default=None)
    ap.add_argument("--snapped-endpoints", action="store_true")
    ap.add_argument("--unfused-endpoints", action="store_true")
    ap.add_argument("--anchor-dither", default=None)
    ap.add_argument("--update-qstep-cells", type=float, default=0.5)
    ap.add_argument("--noise-xy", type=float, default=0.01)
    ap.add_argument("--noise-theta", type=float, default=0.005)
    ap.add_argument("--ungated", action="store_true",
                    help="the device-gated steps (one CUDA graph replay a "
                         "chunk) whatever the particle count")
    # the port's own
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--scans", type=int, default=None,
                    help="the log's first N scans (default: all 653)")
    ap.add_argument("--repeats", type=int, default=5)
    return ap


def configs(args):
    """(FrontendConfig, PFConfig) of bench_pf.py's flags; raises
    NotImplementedError for the settings the port does not carry."""
    not_ported = ("not ported on purpose (ROADMAP.md, queue 1, 'Not "
                  "ported on purpose')")
    if args.refine_chunk != 0:
        raise NotImplementedError(
            f"--refine-chunk {args.refine_chunk}: the TPU's refine chunking "
            f"is {not_ported}")
    if args.fuse_light_prefix is not None:
        raise NotImplementedError(
            "--fuse-light-prefix: the JAX package's light/heavy dispatch "
            f"fusion is {not_ported}; CUDA graphs take its place")
    cfg = FrontendConfig(
        sensor=SensorConfig(n_beams=180, max_range=12.0),
        grid=GridConfig(
            height=args.grid, width=args.grid, resolution=args.resolution,
            ray_samples=int(128 * 0.1 / args.resolution),
            center_x=10.0, center_y=10.0, update_impl=args.update_impl,
        ),
        matcher=MatcherConfig(search_xy=0.25, search_theta=0.12, n_theta=9),
        chunk=32,
        bootstrap_dist=2.0,
        **({"match_min_motion": args.match_min_motion}
           if args.match_min_motion is not None else {}),
    )
    pf = PFConfig(
        n_particles=args.particles, map_dtype=args.map_dtype,
        update_mode=args.update_mode,
        update_theta_slots=args.update_theta_slots,
        update_subcell=args.update_subcell,
        update_bilinear=args.update_bilinear,
        update_qstep_cells=args.update_qstep_cells,
        update_exact_endpoints=not args.snapped_endpoints,
        update_fused_endpoints=not args.unfused_endpoints,
        update_images_f32=args.images_f32,
        noise_xy=args.noise_xy, noise_theta=args.noise_theta,
        **({"update_carve_shrink": args.carve_shrink}
           if args.carve_shrink is not None else {}),
        **({"update_anchor_dither": args.anchor_dither}
           if args.anchor_dither is not None else {}),
    )
    try:
        check_production_mode(pf)
    except NotImplementedError as e:
        raise NotImplementedError(f"{e}: {not_ported}") from None
    return cfg, pf


def main(argv=None):
    args = build_parser().parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("bench_pf_torch.py: no CUDA device (pass --device "
                         "cpu for the CPU test mode)")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", 0)
    cfg, pf = configs(args)
    log = bench_configs.pf_bench_log(cfg.sensor)
    if args.scans is not None:
        log = {k: np.asarray(v)[: args.scans] for k, v in log.items()}
    T = len(log["odom"])
    host_gated = (
        False if args.ungated
        else pf.n_particles >= pf.host_gate_min_particles
    )
    on_cuda = dev.type == "cuda"

    capture_s = None
    if on_cuda and not host_gated and T >= cfg.chunk:
        t0 = time.perf_counter()
        pf_chunk_graph(cfg, pf, dev, cfg.chunk)
        torch.cuda.synchronize(dev)
        capture_s = time.perf_counter() - t0
    run_fastslam(log, cfg, pf, dev, seed=args.seed, host_gated=host_gated)

    fastslam_step.host_syncs = 0
    rates = []
    for _ in range(args.repeats):
        if on_cuda:
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        _, traj, _, _ = run_fastslam(log, cfg, pf, dev, seed=args.seed,
                                     host_gated=host_gated)
        rates.append(T / (time.perf_counter() - t0))
    if not np.isfinite(traj).all():
        raise AssertionError("the trajectory is not finite")
    value = statistics.median(rates)

    sys.path.insert(0, ROOT)
    from bench_torch import session_calibration

    device = {"name": "cpu", "power_limit": None}
    if on_cuda:
        name, limit = (x.strip() for x in bench_configs.card().split(","))
        device = {"name": name, "power_limit": limit}
    print(json.dumps({
        "metric": f"fastslam{pf.n_particles}_scans_per_sec",
        "value": value,
        "unit": "scans/s",
        "vs_baseline": value / REFERENCE_SCANS_PER_SEC,
        "ate_m": float(ate_rmse(traj, log["gt_poses"], align=False)),
        "ate_odom_m": float(ate_rmse(log["odom"], log["gt_poses"],
                                     align=False)),
        "session_calibration": session_calibration(dev),
        "device": device,
        "host_gated": host_gated,
        "host_reads_per_scan": fastslam_step.host_syncs / (args.repeats * T),
        "capture_s": capture_s,
        "runs": rates,
        "scans": T,
        "repeats": args.repeats,
    }))


if __name__ == "__main__":
    main()
