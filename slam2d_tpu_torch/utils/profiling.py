"""Tracing and profiling, the counterpart of the JAX package's
slam2d_tpu/utils/profiling.py.

- `PhaseTimer`: named phase accumulators (host wall time) with a report.
  Where a card is present each phase boundary synchronizes it first, so
  a phase's time is the device work it enqueued, not the time to enqueue
  it. The syncs slow the run: only benches install one.
- `Throughput`: a scans/s counter (`mark_synced` after a hard sync).
- `trace(logdir)`: a `torch.profiler` trace of the host (and of the card
  where one is present), written as a Chrome trace (`trace.json` in
  `logdir`).
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


class PhaseTimer:
    """Named phase accumulators; the card (where present) is synchronized
    at both ends of every phase."""

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        _sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            _sync()
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            t, n = self.totals[name], self.counts[name]
            lines.append(f"{name:24s} {t:8.3f}s  ({n}x, {t / n * 1e3:7.2f} ms avg)")
        return "\n".join(lines)


class Throughput:
    """scans/s counter; call mark_synced(n) after a hard device sync."""

    def __init__(self):
        self.t0 = time.perf_counter()
        self.n = 0

    def mark_synced(self, n_scans: int):
        self.n += n_scans

    @property
    def scans_per_sec(self) -> float:
        dt = time.perf_counter() - self.t0
        return self.n / dt if dt > 0 else 0.0


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block with torch.profiler (the CPU, and the card where
    one is present) and write its Chrome trace to `logdir`/trace.json.
    Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
