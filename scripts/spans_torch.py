#!/usr/bin/env python3
"""The port's span recorder (slam2d_tpu_torch/utils/profiling.py) read
after one benchmark run, and its own cost.

    python3 scripts/spans_torch.py account --cell frontend.dense \
        --seed 11 [--seconds 20] [--out chiprun_out/spans]
    python3 scripts/spans_torch.py cost [--calls 1000]

`account` makes one untraced run of the cell through the harness
(benchmark/harness.py:run_cell, on cuda:0), then reads the program's
records: the calls of the window (after the warm-up session) and the
device span from their first mark to their last, split into the
replays' own device time (`head` to `replayed`), the loads (`load` to
`copied`: the state's and the inputs' copies), the launch waits
(`copied` to `head`), the finishes (`replayed` to `cloned`: the outputs'
copy, the counters, the state's clone) and the hand-offs (`cloned` to
the next call's `load`). It prints one JSON line: the run's
`scans_per_s`, the calls' scans over the device span, the parts and
what is left over, the six `program_span` metrics, and the quartiles of
the per-call graph time a scan; the per-call series (with each call's
session and host start time) goes to <out>/<cell>_<seed>.json.

`cost` times the recorder's work for one chunk-graph call (the spans and
five marks of run_frontend's call, the head's event recorded as a graph
would) on the card, `--calls` calls a repeat (about a 20-s window's: the
pool of events serves them all, and the ring, read and emptied after
each repeat, holds a window's records), with the profiler off (25
repeats), and the same under torch.profiler (CPU and CUDA; 5) against
the bare loop under it: one JSON line of host microseconds a call, the
medians and each repeat.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def account(args) -> dict:
    import torch

    from benchmark import spans
    from benchmark.bench import Bench
    from benchmark.harness import run_cell
    from slam2d_tpu_torch.utils import profiling

    bench = Bench()
    result = run_cell(args.cell, args.seed, args.seconds, False,
                      t_start=time.perf_counter(), bench=bench,
                      device=torch.device("cuda", 0),
                      log=lambda *a, **k: None)
    cs = spans.calls()
    parts = dict(replay=0.0, load=0.0, wait=0.0, finish=0.0, handoff=0.0)
    series, scans = [], 0
    for c in cs:
        marks = {}
        for s in c.spans:
            for k, m in s["marks"].items():
                marks.setdefault(k, []).append(m[1])
        parts["load"] += marks["copied"][0] - marks["load"][0]
        for k, copied, head, done in c.replays():
            parts["wait"] += head - copied
            parts["replay"] += done - head
            series.append((done - head) / k)
            scans += k
        parts["finish"] += marks["cloned"][-1] - marks["replayed"][-1]
    parts["handoff"] = sum(spans.handoffs(cs, same_session=False))
    span = sum(run[-1].last - run[0].first for run in spans.runs(cs))
    q = statistics.quantiles(series, n=4)
    out = {
        "cell": args.cell, "seed": args.seed,
        "correct": result["correct"],
        "scans_per_s": result["metrics"]["scans_per_s"]["value"],
        "calls": len(cs), "marked_scans_per_s": scans / span * 1e6,
        "device_span_us": span,
        "parts_us": parts,
        "left_over_share": 1.0 - sum(parts.values()) / span,
        "metrics": {m["name"]: bench.reader(m["name"])(None)
                    for m in bench.spec["per_layer"]
                    if m["source"] == "program_span"},
        "replay_us_per_scan_quartiles": q,
        "card": torch.cuda.get_device_name(0),
    }
    # the calls' host start times, on the wall clock of the first
    now_ns, now_unix = time.perf_counter_ns(), time.time()
    t0 = cs[0].root["start_ns"]
    path = pathlib.Path(args.out)
    path.mkdir(parents=True, exist_ok=True)
    (path / f"{args.cell}_{args.seed}.json").write_text(json.dumps({
        "sessions": [c.session for c in cs], "replay_us_per_scan": series,
        "t_s": [(c.root["start_ns"] - t0) / 1e9 for c in cs],
        "t0_unix": now_unix - (now_ns - t0) / 1e9}))
    profiling.clear()
    return out


def cost(args) -> dict:
    import torch

    from slam2d_tpu_torch.utils import profiling

    dev = torch.device("cuda", 0)
    head = torch.cuda.Event(enable_timing=True, external=True)
    head.record()

    def recorded():
        with profiling.call(False):
            with profiling.span("call.stage"):
                pass
            with profiling.span("chunk.load"):
                profiling.mark("load", dev)
            with profiling.span("chunk.replay", scans=64):
                profiling.mark("copied", dev)
                profiling.mark("head", dev, head)
                head.record()
                profiling.mark("replayed", dev)
            with profiling.span("chunk.finish"):
                profiling.mark("cloned", dev)

    def bare():
        head.record()

    def per_call(fn, n):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter_ns()
        for _ in range(n):
            fn()
        dt = (time.perf_counter_ns() - t0) / n / 1e3
        torch.cuda.synchronize()
        profiling.records()
        profiling.clear()
        return dt

    n = args.calls
    off = [per_call(recorded, n) - per_call(bare, n) for _ in range(25)]
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    on = []
    for _ in range(5):
        with torch.profiler.profile(activities=acts):
            on.append(per_call(recorded, n) - per_call(bare, n))
    profiling.clear()
    return {"off_us_per_call": statistics.median(off), "off_runs": off,
            "on_us_per_call": statistics.median(on), "on_runs": on,
            "card": torch.cuda.get_device_name(0)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="what", required=True)
    a = sub.add_parser("account")
    a.add_argument("--cell", required=True)
    a.add_argument("--seed", type=int, required=True)
    a.add_argument("--seconds", type=float, default=20.0)
    a.add_argument("--out", default=str(ROOT / "chiprun_out" / "spans"))
    c = sub.add_parser("cost")
    c.add_argument("--calls", type=int, default=1000)
    args = ap.parse_args(argv)
    out = account(args) if args.what == "account" else cost(args)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
