"""The reduction of a torch.profiler trace to the timeline the per-layer
readers read.

The device's busy time is the union of its activities' intervals, as
scripts/profile_torch.py's `_busy_us` takes it at commit
fe37ab964ea616f84f82d44417eea1bff9015b6b, and `kind` sorts the device
kernels as that script does: the port's own kernels (csrc/) are the ones
in an anonymous namespace outside at::. Every timestamp is in
microseconds on the profiler's clock.
"""

from __future__ import annotations

import bisect
import re

import torch

CHUNK_SPAN = "bench.chunk"
_BLAS = re.compile(r"gemm|gemv|cutlass|xmma|cublas", re.IGNORECASE)


def kind(name: str) -> str:
    """"copy" (a memcpy or memset), "hand" (the port's csrc/ kernels),
    "blas" (cuBLAS) or "small" (every other kernel: PyTorch's)."""
    if name.startswith(("Memcpy", "Memset")):
        return "copy"
    if "(anonymous namespace)::" in name and "at::" not in name:
        return "hand"
    if _BLAS.search(name):
        return "blas"
    return "small"


def _union(spans):
    """The union of [start, end) intervals, as sorted disjoint [s, e]."""
    out = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class Timeline:
    """The traced span: `ops` [(name, start, end)] of the device, the
    chunk spans [(start, end)] the harness marked, and the host's other
    events for naming idle gaps."""

    def __init__(self, events):
        self.ops, self.chunks, self.host = [], [], []
        for e in events:
            if e.name.startswith("ProfilerStep"):
                continue
            span = (float(e.time_range.start), float(e.time_range.end))
            if e.device_type == torch.autograd.DeviceType.CUDA:
                # the chunk span's own mirror on the device timeline is an
                # annotation, not an operation
                if e.name != CHUNK_SPAN:
                    self.ops.append((e.name, *span))
            elif e.name == CHUNK_SPAN:
                self.chunks.append(span)
            else:
                self.host.append((e.name, *span))
        self.ops.sort(key=lambda o: o[1])
        self.chunks.sort()
        self.host.sort(key=lambda h: h[1])
        self.start = self.chunks[0][0] if self.chunks else 0.0
        self.end = self.chunks[-1][1] if self.chunks else 0.0
        self.ops = [o for o in self.ops
                    if o[2] > self.start and o[1] < self.end]

    @property
    def window_us(self) -> float:
        return self.end - self.start

    def busy_us(self) -> float:
        return sum(e - s for s, e in _union(
            (max(s, self.start), min(e, self.end)) for _, s, e in self.ops))

    def kernels(self, which: str):
        """[(name, start, end)] of the device kernels of one `kind`."""
        return [o for o in self.ops if kind(o[0]) == which]

    def named(self, pattern: str):
        """[(name, start, end)] of the kernels whose name matches."""
        rx = re.compile(pattern)
        return [o for o in self.ops if rx.search(o[0])]

    def chunk_ops(self):
        """The device ops of each chunk, by their start: every chunk ends
        in a read of its poses, so its work ends before the next begins."""
        starts = [c[0] for c in self.chunks]
        out = [[] for _ in self.chunks]
        for o in self.ops:
            i = bisect.bisect_right(starts, o[1]) - 1
            if i >= 0:
                out[i].append(o)
        return out

    def idle_gaps(self):
        """[(start, end)] of every device idle interval in the span."""
        busy = _union((max(s, self.start), min(e, self.end))
                      for _, s, e in self.ops)
        edges = [self.start] + [x for iv in busy for x in iv] + [self.end]
        return [(s, e) for s, e in zip(edges[::2], edges[1::2]) if e > s]

    def _host_at(self, t: float) -> str:
        """The host's innermost event at time t."""
        inner = None
        for name, s, e in self.host:
            if s > t:
                break
            if e >= t and (inner is None or e - s < inner[1]):
                inner = (name, e - s)
        return inner[0] if inner else "host (no event)"

    def top_ops(self, n: int = 10):
        """[[name, seconds]] of the device ops that took most time."""
        tot = {}
        for name, s, e in self.ops:
            tot[name] = tot.get(name, 0.0) + (e - s)
        top = sorted(tot.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:200], us / 1e6] for name, us in top]

    def top_gaps(self, n: int = 10):
        """[[host label, seconds]] of the longest idle gaps, each named
        after the host's innermost event at its midpoint."""
        gaps = sorted(self.idle_gaps(), key=lambda g: g[0] - g[1])[:n]
        return [[self._host_at(0.5 * (s + e))[:200], (e - s) / 1e6]
                for s, e in gaps]
