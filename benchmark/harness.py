"""One run of one cell: set-up, the measured window, the check and the
result line.

The window is a closed loop with one client: one robot session at a
time, sessions back to back, each from a fresh state over the cell's log,
chunk by chunk through the system's entry. It lasts `seconds` on the host
clock. `scans_per_s` counts the scans whose poses reached the host inside
it, over its length. Each chunk is timed from its handoff (the previous
chunk's return, or the session's start) to its own return; the median
and the 95th percentile go to standard error. The chunk running when the
window closes is not counted.

The check keeps, for chunks drawn from the seed (a session's first chunk
always, in the first session), the state the program returned before and
after the chunk and the chunk's outputs; once the window has closed and
the peak memory is read, the system's `judge` holds them to the plain
reference, and each number is compared with its limit in the cell's file.

With `trace` a torch.profiler trace (CPU and CUDA activities) covers the
cell's traced span of whole chunks inside the window (the window is
stretched until the span is done), and the per-layer readers read it;
the end-to-end metrics are then not reported.
"""

from __future__ import annotations

import contextlib
import statistics
import sys
import time

import numpy as np
import torch

from benchmark.bench import Bench
from benchmark.trace import CHUNK_SPAN, Timeline

FORBIDDEN = ("jax", "jaxlib", "flax", "slam2d_tpu")


def forbidden_modules() -> list:
    """The loaded modules whose top-level name is one of FORBIDDEN."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def seed_value(seed: int) -> int:
    """The run's seed as numpy's and torch's generators take it."""
    return int(seed) % (1 << 63)


def sample_chunks(seed: int, session: int, n_chunks: int, k: int) -> set:
    """The chunks of a session the check keeps: k drawn from the seed, and
    the first chunk in the first session."""
    rng = np.random.default_rng([seed_value(seed), session])
    out = set(rng.choice(n_chunks, size=min(k, n_chunks), replace=False)
              .tolist())
    if session == 0:
        out.add(0)
    return out


def p95(values):
    return float(np.percentile(np.asarray(values, np.float64), 95))


class Context:
    """What a per-layer reader reads."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def run_cell(cell: str, seed: int, seconds: float, trace: bool, *,
             t_start: float, bench: Bench | None = None, device=None,
             control: bool = False, log=print):
    """One run of `cell`; returns the result dict (its keys in order)."""
    bench = bench or Bench()
    w = bench.cell(cell)
    cfg, mix = bench.config(w["config"]), bench.mix(w["traffic"])
    params = bench.cell_params(cell)
    device = torch.device(device or "cuda")
    on_cuda = device.type == "cuda"
    cls = bench.system(cfg)
    if control:
        cls = bench.module("systems", cfg["system"]).Control
    t_init = time.perf_counter()
    system = cls(cfg, mix, seed_value(seed), device)
    t_log = time.perf_counter()

    # set-up: the cell's chunk graph captured, its kernels loaded, one
    # session's first two chunks run
    warm = system.new_session()
    for c in range(min(2, system.n_chunks)):
        system.run_chunk(warm, c)
    del warm
    _sync(device)
    setup_s = time.perf_counter() - t_start
    log(f"set-up {setup_s:.3f} s: imports and the card {t_init - t_start:.3f}"
        f", the log and draws {t_log - t_init:.3f}, the warm chunks (graph "
        f"capture, kernels) {setup_s - (t_log - t_start):.3f}",
        file=sys.stderr)

    per_session = int(params["check_chunks_per_session"])
    first, n_traced = int(params["trace_first_chunk"]), int(
        params["trace_chunks"])
    before = system.counters() if trace else None
    latencies, keeps, traced = [], [], []
    scans = failed = done_chunks = 0
    prof, counts = None, {}
    t0 = time.perf_counter()
    t_end = t0 + seconds
    session, over = 0, False
    while not over:
        sess = system.new_session()
        samples = sample_chunks(seed, session, system.n_chunks, per_session)
        start_keep = None
        handoff = time.perf_counter()
        for c in range(system.n_chunks):
            if trace and done_chunks == first and prof is None:
                _sync(device)
                counts["before"] = system.counters()
                prof = _profiler(on_cuda)
                prof.__enter__()
            span = (torch.profiler.record_function(CHUNK_SPAN)
                    if prof is not None else contextlib.nullcontext())
            with span:
                out = system.run_chunk(sess, c)
            now = time.perf_counter()
            # a traced run goes on until its traced span is done
            if now > t_end and not (trace and "after" not in counts):
                over = True
                break
            latencies.append(now - handoff)
            scans += len(out)
            failed += int((~np.isfinite(out[:, :3]).all(axis=1)).sum())
            done_chunks += 1
            if prof is not None and len(traced) < n_traced:
                traced.append((c, out))
            if c in samples:
                keeps.append(dict(session=session, chunk=c, start=start_keep,
                                  end=system.snapshot(sess), out=out))
            start_keep = system.snapshot(sess) if c + 1 in samples else None
            if prof is not None and len(traced) == n_traced and "after" \
                    not in counts:
                _sync(device)
                prof.__exit__(None, None, None)
                counts["after"] = system.counters()
            handoff = time.perf_counter()
        session += 1
    _sync(device)
    after = system.counters() if trace else None
    peak = torch.cuda.max_memory_allocated(device) if on_cuda else 0
    found = forbidden_modules()
    if found:
        raise SystemExit(f"loaded after the window: {', '.join(found)}")
    log(f"window: {scans} scans in {len(latencies)} chunks over {session} "
        f"sessions, {len(keeps)} chunks kept for the check", file=sys.stderr)

    device_info = {
        "platform": "gpu" if on_cuda else device.type,
        "kind": torch.cuda.get_device_name(device) if on_cuda else "cpu",
        "count": 1,
        "memory_peak_bytes": int(peak),
    }
    metrics, breakdown = {}, None
    if trace:
        t_tl = time.perf_counter()
        tl = Timeline(prof.events())
        log(f"trace: {len(tl.ops)} device operations over {len(traced)} "
            f"chunks, read in {time.perf_counter() - t_tl:.1f} s",
            file=sys.stderr)
        ctx = Context(
            timeline=tl, cell=cell, cfg=cfg, system=system,
            traced=traced, scans_traced=sum(len(o) for _, o in traced),
            counts={k: counts["after"][k] - counts["before"][k]
                    for k in counts["after"]},
            window={k: after[k] - before[k] for k in after},
            scans_window=scans, device_name=device_info["kind"])
        for m in bench.metrics(cell, "per_layer"):
            v = bench.reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        device_info["busy_s"] = tl.busy_us() / 1e6
        device_info["window_s"] = tl.window_us / 1e6
        breakdown = {"device_ops": tl.top_ops(), "idle_gaps": tl.top_gaps()}
        del prof, tl
    else:
        log(f"chunk latency: {len(latencies)} samples, median "
            f"{statistics.median(latencies) * 1e3:.4f} ms, 95th percentile "
            f"{p95(latencies) * 1e3:.4f} ms", file=sys.stderr)
        e2e = {"scans_per_s": scans / seconds, "setup_s": setup_s}
        for m in bench.metrics(cell, "end_to_end"):
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}

    # the check, once the window has closed and the peak is read
    del sess
    _sync(device)
    numbers, counts_checked = system.judge(keeps, device)
    limits = params["limits"]
    checked = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    correct = bool(keeps) and all(
        v["value"] <= v["limit"] for v in checked.values())
    log(f"check over {len(keeps)} chunks: {counts_checked}", file=sys.stderr)
    for k, v in checked.items():
        log(f"check {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    result = {"correct": correct, "attempted": scans, "failed": failed,
              "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checked"] = checked
    return result


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _profiler(on_cuda: bool):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if on_cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)
