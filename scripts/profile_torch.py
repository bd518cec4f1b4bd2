#!/usr/bin/env python3
"""Where the time goes in the PyTorch port on one GPU.

    python3 scripts/profile_torch.py frontend|ray|localize|tiled
        [--warm 256] [--scans 256] [--eager]
    python3 scripts/profile_torch.py fastslam|fastslam1000|fastslam16
        [--warm 128] [--scans 192] [--seeds N] [--graph]
    python3 scripts/profile_torch.py fullslam [--warm 384] [--scans 331]
    python3 scripts/profile_torch.py schur [--warm 2] [--scans 3]
    python3 scripts/profile_torch.py hier [--warm 1] [--scans 1]
    (all: [--out profile_out])

Runs the port (slam2d_tpu_torch) at bench.py's config and log (frontend;
ray: with update_impl="pallas_ray"; localize: localization on the final
map of a frontend run over bench.py's log, along its localization log;
tiled: the tiled frontend at the CLI's tile defaults over a lap of the
corridor world, its host loop included; fullslam: full SLAM at the CLI's
`--mode full` defaults over two laps of bench.py's world, run_full_slam
over the warmup scans and then over the traced ones resumed from its
checkpoint; schur: `--scans` Schur solves (graph/schur.py, 4 blocks,
the host's plan and tables included) of that run's final graph, after
`--warm` untraced ones, with the plan, the tables and the iterations
timed apart first; hier: `--scans` optimize_hier solves of the 4096-node
serpentine graph of tests/test_sparse_graph.py (chip_smoke.py phase 19's,
bench_configs.hier_bench_graph), after `--warm` untraced
ones, with the host's plan and a whole solve timed apart first) or at
bench_pf.py's default config and log with 100, 1000
or 16 particles (fastslam, fastslam1000, fastslam16; bf16 512^2 maps): a
warmup over the first `--warm` scans, then a torch.profiler
trace (CPU and CUDA activities) of the next `--scans` scans. The
frontend and localization run as run_frontend runs them on CUDA, one
CUDA graph replay a chunk (`--warm` and `--scans` whole chunks);
`--eager` steps them one by one instead. FastSLAM runs host-gated
(fastslam_step with the host's gates), or with `--graph` as
run_fastslam(host_gated=False) runs it on CUDA: the device-gated steps,
one PFChunkGraph replay a chunk of 32 (`--warm` and `--scans` whole
chunks), the draws from a seeded generator a chunk at a time. Prints the
kernels by device time, then one JSON line: the device busy share of the
traced wall time, per-scan host time, the step's counters, the largest
device costs and every kernel of the port's own. Writes the
gzipped Chrome trace to `--out`. For fastslam, `--seeds N` first runs the
whole log for proposal seeds 0..N-1 and prints each run's ATE and scans/s
(CUDA events), their median and range. For fullslam, a whole run first
times each accepted loop's graph solve (LoopCloser._dispatch_optimize:
the graph's copy, the dense solve and the chi2 prune) and its map
rebuild (IncrementalRebuilder), each between two synchronizes, and
prints them. Needs a CUDA device.
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

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from slam2d_tpu_torch.metrics import ate_rmse  # noqa: E402
from slam2d_tpu_torch.pf.fastslam import (  # noqa: E402
    fastslam_init,
    fastslam_step,
    host_gate_flags,
)
from slam2d_tpu_torch.run import bench_configs  # noqa: E402
from slam2d_tpu_torch.run.fastslam_run import (  # noqa: E402
    pf_chunk_graph,
    run_fastslam,
)
from slam2d_tpu_torch.run.frontend import (  # noqa: E402
    chunk_graph,
    frontend_init,
    frontend_step,
    graph_capturable,
    localization_init,
    run_frontend,
)
from slam2d_tpu_torch.run.frontend_tiled import (  # noqa: E402
    run_tiled_frontend,
    tiled_frontend_step,
)
from slam2d_tpu_torch.run import full_slam  # noqa: E402

DEFAULTS = {  # warm, scans
    "frontend": (256, 256), "ray": (256, 256), "localize": (256, 256),
    "tiled": (256, 256), "fastslam": (128, 192),
    "fastslam1000": (128, 192), "fastslam16": (128, 192),
    # the second lap, where the loops close (715 scans in all)
    "fullslam": (384, 331),
    "schur": (2, 3),   # solves, not scans
    "hier": (1, 1),    # solves, not scans
}
PF_CONFIGS = {
    "fastslam": bench_configs.pf_bench_config,
    "fastslam1000": bench_configs.pf1000_bench_config,
    "fastslam16": bench_configs.pf_per_particle_bench_config,
}


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


def _step_runner(dev, cfg, state, log, eager):
    """steps(lo, hi) over scans lo..hi-1 of `log` from `state`: replays of
    the config's CUDA graph, one a chunk, as run_frontend runs them (lo
    and hi multiples of cfg.chunk), or with `eager` (or an update that
    reads its gate on the host) the steps one by one."""
    if eager or not graph_capturable(cfg):
        odom = torch.as_tensor(log["odom"], device=dev)
        ranges = torch.as_tensor(log["ranges"], device=dev)

        def steps(lo, hi):
            nonlocal state
            for k in range(lo, hi):
                state, _ = frontend_step(state, odom[k], ranges[k], cfg)

        return steps
    K = cfg.chunk
    g = chunk_graph(cfg, dev, K)
    g.load(state)
    odom = torch.from_numpy(np.ascontiguousarray(log["odom"], np.float32))
    ranges = torch.from_numpy(np.ascontiguousarray(log["ranges"], np.float32))
    odom, ranges = odom.pin_memory(), ranges.pin_memory()
    out = torch.empty((K, 4), dtype=torch.float32, device=dev)

    def steps(lo, hi):
        if lo % K or hi % K:
            raise ValueError(f"graph replays run whole chunks of {K} scans")
        for s in range(lo, hi, K):
            g.run_chunk(odom[s : s + K], ranges[s : s + K], out)
        g.flush_counts()

    return steps


def frontend_steps(dev, cfg, eager=False):
    """(steps(lo, hi) running the frontend over scans lo..hi-1, counters)."""
    log = bench_configs.bench_log(cfg.sensor)
    state = frontend_init(cfg, dev, start_pose=log["odom"][0],
                          start_odom=log["odom"][0])
    steps = _step_runner(dev, cfg, state, log, eager)
    return steps, frontend_step, ("host_syncs", "matches", "updates")


def localize_steps(dev, cfg, eager=False):
    """(steps, counters) of localization on the final map of a frontend run
    over bench.py's log (built before the trace), along its localization
    log, as run_localization runs it."""
    log = bench_configs.bench_log(cfg.sensor)
    mapped, _, _ = run_frontend(log, cfg, dev)
    loc = bench_configs.localization_log(cfg.sensor)
    cfg, state = localization_init(cfg, mapped.logodds, loc["odom"][0], dev)
    steps = _step_runner(dev, cfg, state, loc, eager)
    return steps, frontend_step, ("host_syncs", "matches", "updates")


def tiled_steps(dev):
    """(steps, counters) of the tiled frontend: run_tiled_frontend over
    scans lo..hi-1 (whole chunks) with the state carried, so its host loop
    (forecast, activation, one pose read a chunk) is in the trace."""
    cfg, tcfg = bench_configs.tiled_bench_config()
    log = bench_configs.tiled_bench_log(cfg.sensor)
    state = None

    def steps(lo, hi):
        nonlocal state
        part = {k: np.asarray(v)[lo:hi] for k, v in log.items()}
        state, _, _ = run_tiled_frontend(part, cfg, tcfg, dev, state=state)

    return steps, tiled_frontend_step, ("host_syncs", "matches", "updates")


def accept_times(cfg, gcfg, log, dev):
    """ms of each accepted loop's graph solve and of its map rebuild over a
    whole run, each between two synchronizes (which the run otherwise
    does not take), with the run's scans/s beside them."""
    times = {"solve": [], "rebuild": []}
    cls = {"solve": (full_slam.LoopCloser, "_dispatch_optimize"),
           "rebuild": (full_slam.IncrementalRebuilder, "__call__")}
    orig = {k: getattr(c, n) for k, (c, n) in cls.items()}

    def timed(fn, out):
        def wrap(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = fn(*a, **k)
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
            return r
        return wrap

    full_slam.run_full_slam(log, cfg, gcfg, device=dev)   # warm
    for k, (c, n) in cls.items():
        setattr(c, n, timed(orig[k], times[k]))
    try:
        t0 = time.perf_counter()
        res = full_slam.run_full_slam(log, cfg, gcfg, device=dev)
        sec = time.perf_counter() - t0
    finally:
        for k, (c, n) in cls.items():
            setattr(c, n, orig[k])
    print(json.dumps(dict(
        card=bench_configs.card(), scans=len(res.traj),
        scans_per_sec_synced=len(res.traj) / sec, n_loops=res.n_loops,
        solve_ms=times["solve"], rebuild_ms=times["rebuild"],
        solve_ms_median=statistics.median(times["solve"] or [0.0]),
        rebuild_ms_median=statistics.median(times["rebuild"] or [0.0]),
    )))


def fullslam_steps(dev):
    """(steps, counters) of full SLAM: run_full_slam over scans lo..hi-1,
    resumed from the previous part's checkpoint; accept_times first."""
    cfg, gcfg = bench_configs.fullslam_bench_config()
    log = bench_configs.fullslam_bench_log(cfg.sensor)
    accept_times(cfg, gcfg, log, dev)
    ckpt = None

    def steps(lo, hi):
        nonlocal ckpt
        part = {k: np.asarray(v)[lo:hi] for k, v in log.items()}
        ckpt = full_slam.run_full_slam(part, cfg, gcfg, device=dev,
                                       resume=ckpt,
                                       scan_index_offset=lo).ckpt

    return steps, frontend_step, ("host_syncs", "matches", "updates")


def schur_steps(dev):
    """(steps(lo, hi) making hi - lo Schur solves of full SLAM's final
    graph, counters); first the plan, the tables and the iterations each
    timed apart (median of 5, synced)."""
    from slam2d_tpu_torch.graph import schur, se2_graph

    cfg, gcfg = bench_configs.fullslam_bench_config()
    log = bench_configs.fullslam_bench_log(cfg.sensor)
    res = full_slam.run_full_slam(log, cfg, gcfg, device=dev)
    host = se2_graph.HostGraph.from_arrays(gcfg, res.ckpt["graph"])
    g = host.to_device(dev)

    def ms(fn):
        out = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(out)

    plan = schur.build_plan(host, 4)
    tables = schur.schur_tables(plan, dev)
    print(json.dumps(dict(
        card=bench_configs.card(), nodes=host.n_nodes, edges=host.n_edges,
        separators=plan.n_sep, interior_slots=plan.int_ids.shape[1],
        plan_ms=ms(lambda: schur.build_plan(host, 4)),
        tables_ms=ms(lambda: schur.schur_tables(plan, dev)),
        iterations_ms=ms(lambda: schur.optimize_schur(
            g, gcfg, 4, plan=plan, tables=tables)),
        solve_ms=ms(lambda: schur.optimize_schur(
            g, gcfg, 4, plan=schur.build_plan(host, 4))),
        dense_ms=ms(lambda: se2_graph.optimize(g, gcfg)),
    )))

    def steps(lo, hi):
        for _ in range(lo, hi):
            schur.optimize_schur(g, gcfg, 4, plan=schur.build_plan(host, 4))

    return steps, steps, ()


def hier_steps(dev):
    """(steps(lo, hi) making hi - lo optimize_hier solves of the 4096-node
    serpentine, counters); first the plan and a whole solve timed apart
    (median of 3, synced) and the stages a solve runs."""
    from slam2d_tpu_torch.config import GraphConfig
    from slam2d_tpu_torch.graph import se2_graph, sparse
    from slam2d_tpu_torch.ops.tridiag import tridiag_factor

    K = 4096
    arrays, _, _, ckw = bench_configs.hier_bench_graph(K)
    gcfg = GraphConfig(**ckw)
    g = se2_graph.PoseGraph(**{k: torch.as_tensor(v, device=dev)
                               for k, v in arrays.items()})
    plan = sparse.sparse_plan(g, gcfg, dev, hier=True)

    def ms(fn):
        out = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(out)

    before = dict(sparse.optimize_hier.stages)
    launches = tridiag_factor.launches
    sparse.optimize_hier(g, gcfg, plan=plan)
    stages = {k: sparse.optimize_hier.stages[k] - v
              for k, v in before.items()}
    print(json.dumps(dict(
        card=bench_configs.card(), nodes=K, levels=[lv.K for lv in
                                                    plan.levels],
        stages_a_solve=stages,
        tridiag_launches_a_solve=tridiag_factor.launches - launches,
        plan_ms=ms(lambda: sparse.sparse_plan(g, gcfg, dev, hier=True)),
        solve_ms=ms(lambda: sparse.optimize_hier(g, gcfg, plan=plan)),
    )))

    def steps(lo, hi):
        for _ in range(lo, hi):
            sparse.optimize_hier(g, gcfg, plan=plan)

    return steps, steps, ()


def fastslam_steps(dev, cfg, pf, seeds, graph):
    """(steps(lo, hi) running FastSLAM over scans lo..hi-1, counters);
    with `seeds`, the whole-log sweep first. `graph`: the device-gated
    chunk graph's replays (lo and hi multiples of cfg.chunk) in place of
    the host-gated steps."""
    log = bench_configs.pf_bench_log(cfg.sensor)
    if seeds:
        seed_sweep(cfg, pf, log, dev, seeds, graph)
    flags = host_gate_flags(log["odom"], cfg, log["odom"][0], 0.0, np.inf)
    odom = torch.as_tensor(log["odom"], device=dev)
    ranges = torch.as_tensor(log["ranges"], device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    state = fastslam_init(cfg, pf, dev, start_pose=log["odom"][0])
    counters = ("host_syncs", "refines", "updates", "resamples")
    if graph:
        K, P = cfg.chunk, pf.n_particles
        g = pf_chunk_graph(cfg, pf, dev, K)
        g.load(state)
        odom_p = torch.from_numpy(np.asarray(log["odom"], np.float32))
        ranges_p = torch.from_numpy(np.asarray(log["ranges"], np.float32))
        odom_p, ranges_p = odom_p.pin_memory(), ranges_p.pin_memory()
        out = torch.empty((K, 5), dtype=torch.float32, device=dev)

        def replays(lo, hi):
            for s in range(lo, hi, K):
                g.run_chunk(
                    odom_p[s : s + K], ranges_p[s : s + K],
                    torch.randn((K, P, 3), generator=gen, device=dev),
                    torch.rand(K, generator=gen, device=dev), out)
            # the replays' counts into fastslam_step's (no host read)
            fastslam_step.counter(dev).add_(g.counts)
            g.counts.zero_()

        return replays, fastslam_step, counters

    def steps(lo, hi):
        nonlocal state
        for k in range(lo, hi):
            state, _ = fastslam_step(
                state, odom[k], ranges[k], cfg, pf, gates=flags[k],
                generator=gen,
            )

    return steps, fastslam_step, counters


def seed_sweep(cfg, pf, log, dev, n, graph):
    """ATE and scans/s (CUDA events) of whole runs for proposal seeds
    0..n-1, with their median and range; host-gated, or device-gated
    (one chunk graph replay a chunk) with `graph`."""
    ate_odom = ate_rmse(log["odom"], log["gt_poses"], align=False)
    run_fastslam(log, cfg, pf, dev, seed=0, host_gated=not graph)   # warm
    out = []
    for seed in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        _, traj, _, _ = run_fastslam(log, cfg, pf, dev, seed=seed,
                                     host_gated=not graph)
        end.record()
        end.synchronize()
        sec = start.elapsed_time(end) / 1e3
        out.append(dict(seed=seed, ate_m=ate_rmse(traj, log["gt_poses"],
                                                  align=False),
                        scans_per_sec=len(traj) / sec))
    rates = [r["scans_per_sec"] for r in out]
    print(json.dumps(dict(
        card=bench_configs.card(), ate_odom_m=ate_odom, runs=out,
        scans_per_sec_median=statistics.median(rates),
        scans_per_sec_range=[min(rates), max(rates)],
    )))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("pipeline", choices=sorted(DEFAULTS))
    ap.add_argument("--warm", type=int)
    ap.add_argument("--scans", type=int)
    ap.add_argument("--seeds", type=int, default=0)
    ap.add_argument("--eager", action="store_true")
    ap.add_argument("--graph", action="store_true")
    ap.add_argument("--out", default="profile_out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch.py needs a CUDA device")
    dev = torch.device("cuda", 0)
    warm, n = DEFAULTS[args.pipeline]
    warm = warm if args.warm is None else args.warm
    n = n if args.scans is None else args.scans
    if args.pipeline == "frontend":
        steps, step, counters = frontend_steps(
            dev, bench_configs.bench_config(), args.eager)
    elif args.pipeline == "ray":
        steps, step, counters = frontend_steps(
            dev, bench_configs.ray_bench_config()
        )
    elif args.pipeline == "localize":
        steps, step, counters = localize_steps(
            dev, bench_configs.bench_config(), args.eager)
    elif args.pipeline == "tiled":
        steps, step, counters = tiled_steps(dev)
    elif args.pipeline == "fullslam":
        steps, step, counters = fullslam_steps(dev)
    elif args.pipeline == "schur":
        steps, step, counters = schur_steps(dev)
    elif args.pipeline == "hier":
        steps, step, counters = hier_steps(dev)
    else:
        cfg, pf = PF_CONFIGS[args.pipeline]()
        steps, step, counters = fastslam_steps(dev, cfg, pf, args.seeds,
                                               args.graph)

    steps(0, warm)
    torch.cuda.synchronize()
    for name in counters:
        setattr(step, name, 0)
    full_slam.fetch.reads = 0
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        steps(warm, warm + n)
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
    print(json.dumps(dict(
        card=bench_configs.card(), pipeline=args.pipeline, scans=n,
        graph=args.graph,
        first_scan=warm, wall_ms=wall_us / 1e3, us_per_scan=wall_us / n,
        device_busy_us=busy, device_busy_share=busy / wall_us,
        device_kernels=sum(v[0] for v in kernels.values()),
        **{name: getattr(step, name) for name in counters},
        **({"fetch_reads": full_slam.fetch.reads}
           if args.pipeline == "fullslam" else {}),
        top_kernels=[dict(name=k[:90], launches=v[0], us=v[1])
                     for k, v in top[:14]],
        # the port's own kernels (csrc/: anonymous namespaces outside at::)
        port_kernels=[dict(name=k[:90], launches=v[0], us=v[1])
                      for k, v in top
                      if "(anonymous namespace)::" in k and "at::" not in k],
    )))
    os.makedirs(args.out, exist_ok=True)
    prof.export_chrome_trace(
        os.path.join(args.out, f"torch_{args.pipeline}_trace.json.gz")
    )


if __name__ == "__main__":
    main()
