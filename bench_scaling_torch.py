#!/usr/bin/env python3
"""Weak-scaling benchmark of the PyTorch port's sharded FastSLAM, the twin
of bench_scaling.py (BASELINE metric "scaling efficiency 1 -> N").

    python3 bench_scaling_torch.py [--ranks 1 2 4] [--particles-per-rank 8]
        [--grid 192] [--scans 64]
    python3 bench_scaling_torch.py --device cpu --ranks 1 2 --grid 64 --scans 32   (tests)

Weak scaling: the particles a rank held constant while the ranks grow,
each rank count one world of processes (parallel/mesh.py:spawn) running
run/sharded_run.py:run_sharded_fastslam over bench_scaling.py's log and
config (90 beams to 10 m, a grid of --grid^2 cells at 0.1 m, chunk 16,
the 12 m box-rooms world at 0.1 m steps, the first --scans scans). After
one warm-up run of the first chunk, the whole run is timed on every rank
between two barriers (the first rank's seconds); then, at the same
shapes and on the same world:

- the collective kinds of the PF's schedule, each alone, --scans steps
  (the least of five timings, µs a step): the packed log-normalize
  (`_global_log_normalize`, one all_gather of each rank's [3] stats),
  the resample's CDF all_gather (each rank's [Pl, 4] log-weights and
  poses), the best pose's packed all_gather ([5]) and one ring hop of
  the map block (a ppermute of [Pl, grid^2] and kernel 4's row gather
  over the pair, as pf/sharded.py:ring_exchange takes a hop);
- the collectives-only step: that schedule with no matcher or update,
  every step (the upper bound) and at the production cadence (the
  normalize one step in 3, the CDF and the ring one in 20), steps/s;
- host saturation: the ranks' process CPU seconds over the run's wall
  seconds and the host's cores.

Backends: on CUDA, NCCL when every rank has a card of its own (one rank:
cuda:0), else gloo with every rank on cuda:0 (NCCL refuses two ranks on
one card), CUDA operands staged through the host and counted; `--device
cpu` runs gloo ranks. Without a card, a CUDA run raises.

Runs whose ranks time-share one card or the CPU measure the collectives'
structure and the host staging, not scaling: their lines carry
`"ranks_share_device": true` and `"scaling": "structure"`.

Prints, for each rank count, bench_scaling.py's lines (the keys whose
meaning holds: `sharded_pf_scans_per_sec` with `devices` (the mesh
size), `particles`, `value`, `cpu_seconds`, `host_cpu_utilization`,
`host_cores`; `ancestor_ring_distance_histogram` over the resamples'
particles; `per_collective_step_cost_us`; `collectives_only*_steps_per
_sec`), each with `backend`, `ranks_share_device`, `scaling` and the
run's `bytes_staged_per_scan_per_rank` (the mesh's own counter), then
the summary lines `weak_scaling_efficiency` and `weak_scaling_evidence`,
and `device` (the card's name and power limit as `nvidia-smi
--query-gpu=name,power.limit --format=csv,noheader` prints them).
"""

from __future__ import annotations

import argparse
import json
import os
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
from slam2d_tpu_torch.data.synth import SynthWorld, simulate_log
from slam2d_tpu_torch.ops.gather import gather_rows
from slam2d_tpu_torch.parallel import mesh as pmesh
from slam2d_tpu_torch.pf import sharded
from slam2d_tpu_torch.pf.sharded import _global_log_normalize, local_count
from slam2d_tpu_torch.run import bench_configs
from slam2d_tpu_torch.run.sharded_run import run_sharded_fastslam

PRODUCTION_CADENCE = (3, 20)  # bench_scaling.py's: refine 1 in 3, ring 1 in 20
TIMINGS = 5                   # the least of five timings (bench_scaling.py's)


def config(grid: int) -> FrontendConfig:
    """bench_scaling.py's FrontendConfig at a grid of grid^2 cells."""
    return FrontendConfig(
        sensor=SensorConfig(n_beams=90, max_range=10.0),
        grid=GridConfig(
            height=grid, width=grid, resolution=0.1, ray_samples=96,
            center_x=6.0, center_y=6.0,
        ),
        matcher=MatcherConfig(search_xy=0.2, search_theta=0.1, n_theta=7),
        chunk=16,
        bootstrap_dist=1.0,
    )


def scaling_log(cfg: FrontendConfig, scans: int) -> dict:
    """bench_scaling.py's log, its first min(scans, whole chunks) scans."""
    wp = np.array([[3.0, 3.0], [3.0, 9.0], [9.0, 9.0], [9.0, 3.5],
                   [3.5, 3.0]])
    log = simulate_log(SynthWorld.box_rooms(12.0), wp, cfg.sensor, step=0.1,
                       seed=0)
    T = min(scans, (len(log["odom"]) // cfg.chunk) * cfg.chunk)
    return {k: np.asarray(v)[:T] for k, v in log.items()}


def placement(n: int, device: str):
    """(backend, device for spawn, ranks_share_device) of n ranks."""
    if torch.device(device).type == "cpu":
        return "gloo", "cpu", n > 1
    if not torch.cuda.is_available():
        raise SystemExit("bench_scaling_torch.py: no CUDA device (pass "
                         "--device cpu for the CPU test mode)")
    if n <= torch.cuda.device_count():
        return "nccl", None, False
    return "gloo", "cuda:0", True


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _least(fn, dev) -> float:
    """The least of TIMINGS timings of fn(), in seconds, each synced and
    started together on every rank."""
    mesh = pmesh.current()
    best = float("inf")
    for _ in range(TIMINGS):
        mesh.barrier()
        _sync(dev)
        t0 = time.perf_counter()
        fn()
        _sync(dev)
        best = min(best, time.perf_counter() - t0)
    return best


def _collectives(mesh, Pl: int, grid: int, steps: int, dtype) -> dict:
    """The probes of the PF's collective schedule (module docstring)."""
    dev = mesh.device
    f32 = dict(dtype=torch.float32, device=dev)
    lw = torch.zeros(Pl, **f32)
    packed = torch.zeros((Pl, 4), **f32)
    cand = torch.zeros(5, **f32)
    blk = torch.zeros((Pl, grid * grid), dtype=dtype, device=dev)
    pair = torch.empty((2 * Pl, grid * grid), dtype=dtype, device=dev)
    ar = torch.arange(Pl, device=dev)
    anc = torch.cat([Pl + ar, Pl + ar]).to(torch.int32)

    def hop():
        mesh.ppermute(blk, out=pair[Pl:])
        pair[:Pl].copy_(blk)
        return gather_rows(pair, anc)

    kinds = {
        "normalize_psum": lambda: _global_log_normalize(lw, mesh),
        "cdf_all_gather": lambda: mesh.all_gather(packed, tiled=True),
        "best_pose_all_gather": lambda: mesh.all_gather(cand),
        "ring_ppermute_hop": hop,
    }
    out = {}
    for name, one in kinds.items():
        one()

        def many(one=one):
            for _ in range(steps):
                one()

        out[name] = _least(many, dev) / steps * 1e6

    def schedule(refine_every, ring_every):
        for i in range(steps):
            if i % refine_every == 0:
                kinds["normalize_psum"]()
            if i % ring_every == 0:
                kinds["cdf_all_gather"]()
                hop()
            kinds["best_pose_all_gather"]()

    rates = {}
    for tag, (re_, ri_) in (("", (1, 1)),
                            ("_production_cadence", PRODUCTION_CADENCE)):
        rates[tag] = steps / _least(lambda: schedule(re_, ri_), dev)
    return dict(per_collective_us=out, collectives_only_steps_per_sec=rates)


def rank_run(mesh, cfg, pf, log, grid):
    """One rank's share of one rank count: the timed run and the probes.
    Returns a dict (the trajectory, this rank's seconds, CPU seconds and
    staged bytes, the resamples and hops, its particles' ring distances
    at the resamples, the probes)."""
    dev = mesh.device
    T = len(log["odom"])
    k_needs = []
    ring = sharded.ring_exchange

    def counted(*a, **kw):
        maps, k_need = ring(*a, **kw)
        k_needs.append(k_need.cpu().numpy())
        return maps, k_need

    # ring_exchange counts its hops on the module's name, this wrapper
    counted.hops, counted.d_max = 0, []
    sharded.ring_exchange = counted
    try:
        warm = {k: v[: cfg.chunk] for k, v in log.items()}
        run_sharded_fastslam(warm, cfg, pf, seed=0, mesh=mesh)
        k_needs.clear()
        sharded.sharded_step.resamples = 0
        counted.hops = 0
        mesh.barrier()
        _sync(dev)
        staged0 = mesh.staged_bytes
        c0 = sum(os.times()[:2])
        t0 = time.perf_counter()
        _, traj, _, _ = run_sharded_fastslam(log, cfg, pf, seed=0,
                                             mesh=mesh)
        _sync(dev)
        seconds = time.perf_counter() - t0
        cpu_s = sum(os.times()[:2]) - c0
        staged = mesh.staged_bytes - staged0
    finally:
        sharded.ring_exchange = ring
    step = sharded.sharded_step
    probes = _collectives(mesh, local_count(pf, mesh), grid, T,
                          getattr(torch, pf.map_dtype))
    return dict(
        traj=traj, seconds=seconds, cpu_seconds=cpu_s, staged_bytes=staged,
        resamples=step.resamples, ring_hops=counted.hops,
        k_need=(np.concatenate(k_needs) if k_needs
                else np.zeros(0, np.int32)),
        **probes,
    )


def measure(n: int, args, cfg, log) -> dict:
    """One rank count: every rank's rank_run through spawn, folded into
    the numbers of its lines."""
    backend, device, shared = placement(n, args.device)
    pf = PFConfig(n_particles=args.particles_per_rank * n)
    ranks = pmesh.spawn(rank_run, n, backend, device,
                        args=(cfg, pf, log, args.grid))
    T = len(log["odom"])
    r0 = ranks[0]
    seconds = r0["seconds"]
    cpu_s = sum(r["cpu_seconds"] for r in ranks)
    n_cores = os.cpu_count() or 1
    hist = np.bincount(np.concatenate([r["k_need"] for r in ranks]),
                       minlength=n).astype(int)
    return dict(
        ranks=n, backend=backend, ranks_share_device=shared,
        scaling=("structure" if shared or args.device == "cpu"
                 else "devices"),
        particles=pf.n_particles, scans=T, scans_per_sec=T / seconds,
        seconds=seconds, cpu_seconds=cpu_s,
        host_cpu_utilization=cpu_s / (seconds * n_cores), host_cores=n_cores,
        bytes_staged_per_scan_per_rank=float(
            np.mean([r["staged_bytes"] for r in ranks]) / T),
        resamples=r0["resamples"], ring_hops=r0["ring_hops"],
        histogram=hist.tolist(),
        per_collective_us=r0["per_collective_us"],
        collectives_only=r0["collectives_only_steps_per_sec"],
        traj=r0["traj"],
    )


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, nargs="+", default=[1, 2, 4],
                    help="rank counts (bench_scaling.py's --devices)")
    ap.add_argument("--particles-per-rank", type=int, default=8)
    ap.add_argument("--grid", type=int, default=192)
    ap.add_argument("--scans", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    cfg = config(args.grid)
    log = scaling_log(cfg, args.scans)
    device = {"name": "cpu", "power_limit": None}
    if torch.device(args.device).type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("bench_scaling_torch.py: no CUDA device (pass "
                             "--device cpu for the CPU test mode)")
        name, limit = (x.strip() for x in bench_configs.card().split(","))
        device = {"name": name, "power_limit": limit}
    res = {}
    for n in args.ranks:
        m = res[n] = measure(n, args, cfg, log)
        tags = dict(backend=m["backend"],
                    ranks_share_device=m["ranks_share_device"],
                    scaling=m["scaling"],
                    bytes_staged_per_scan_per_rank=m[
                        "bytes_staged_per_scan_per_rank"],
                    device=device)
        print(json.dumps({
            "metric": "sharded_pf_scans_per_sec", "devices": n,
            "particles": m["particles"], "value": m["scans_per_sec"],
            "unit": "scans/s", "cpu_seconds": m["cpu_seconds"],
            "host_cpu_utilization": m["host_cpu_utilization"],
            "host_cores": m["host_cores"], "scans": m["scans"],
            "resamples": m["resamples"], "ring_hops": m["ring_hops"],
            **tags}), flush=True)
        hist = m["histogram"]
        print(json.dumps({
            "metric": "ancestor_ring_distance_histogram", "devices": n,
            "histogram": hist,
            "frac_zero_hops": hist[0] / max(sum(hist), 1), **tags}),
            flush=True)
        print(json.dumps({"metric": "per_collective_step_cost_us",
                          "devices": n, **m["per_collective_us"], **tags}),
              flush=True)
        for tag, rate in m["collectives_only"].items():
            print(json.dumps({
                "metric": f"collectives_only{tag}_steps_per_sec",
                "devices": n, "value": rate, "unit": "steps/s", **tags}),
                flush=True)

    base, top = args.ranks[0], max(args.ranks)
    shared = any(m["ranks_share_device"] for m in res.values())
    scaling = ("structure" if shared or args.device == "cpu"
               else "devices")
    eff = res[top]["scans_per_sec"] / res[base]["scans_per_sec"]
    # collectives-only efficiency from the first mesh of more than one
    # rank: at one rank the collectives do nothing (bench_scaling.py's)
    cbase = min((n for n in args.ranks if n > 1), default=base)
    coll = {tag: res[top]["collectives_only"][tag]
            / res[cbase]["collectives_only"][tag]
            for tag in res[top]["collectives_only"]}
    util = {n: res[n]["host_cpu_utilization"] for n in args.ranks}
    work_growth = (util[top] * res[base]["scans_per_sec"]
                   / (util[base] * res[top]["scans_per_sec"]))
    n_cores = res[top]["host_cores"]
    print(json.dumps({
        "metric": "weak_scaling_efficiency", "value": eff,
        "unit": f"x{base}->{top}dev", "vs_baseline": eff / 0.8,
        "ranks_share_device": shared, "scaling": scaling, "device": device,
    }))
    print(json.dumps({
        "metric": "weak_scaling_evidence",
        "collectives_only_efficiency": coll[""],
        "collectives_production_cadence_efficiency":
            coll["_production_cadence"],
        "collectives_efficiency_base_devices": cbase,
        "cpu_seconds_per_scan_growth": work_growth,
        "width_growth": top // base,
        "host_cpu_utilization": {str(k): v for k, v in util.items()},
        "host_cores": n_cores,
        "host_bound": n_cores < top,
        "bytes_staged_per_scan_per_rank": {
            str(n): res[n]["bytes_staged_per_scan_per_rank"]
            for n in args.ranks},
        "ranks_share_device": shared, "scaling": scaling,
        "interpretation": (
            "the ranks time-share one device: the numbers measure the "
            "collectives' structure and the host staging, not scaling"
            if scaling == "structure" else
            "one card a rank over NCCL: wall-clock weak scaling"),
        "device": device,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
