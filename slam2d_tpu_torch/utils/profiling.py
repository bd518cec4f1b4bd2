"""Tracing and profiling of the port.

- The span recorder, always on: `span(name, **ids)` appends one record to
  a bounded in-memory ring (`records()`, `clear()`); `call(fresh)` opens
  an entry point's `call` span; `mark(name, device)` puts a device mark
  (a CUDA timing event) into the innermost open span. Under
  `torch.profiler` a span also opens a profiler range of its name (a host
  event, with no copy among the device's activities), so the program's
  spans sit on the trace's clock; with the profiler off none is opened.
  The recorder reads nothing back from the card and never synchronizes
  it.
- `PhaseTimer`: named phase accumulators (host wall time) with a report.
  Where a card is present each phase boundary synchronizes it first, so
  a phase's time is the device work it enqueued, not the time to enqueue
  it. The syncs slow the run: only benches install one.

A record is a dict: `id`, `name`, `parent` (the enclosing span's id, or
None), `session` and `call` (the entry's session id and call number,
None outside an entry), `profiled` (whether torch.profiler was on),
`start_ns` and `end_ns` (host `time.perf_counter_ns`), `marks` (name ->
[host ns when recorded, device us]) and the span's `ids`. A mark's device
time is in microseconds on one clock per device (0 at the device's first
mark), None until it is resolved or where it was lost. `records()`
resolves the marks whose events have completed, asking each with
`Event.query()` first; a caller reads them once its own read of its
outputs has drained the stream. A graph's head event, recorded again at
every replay, is settled the same way (into an offset from the mark
before it) when its next replay is marked.

The spans of the drivers (run/frontend.py:run_frontend,
run/fastslam_run.py:run_fastslam, run/capture.py:ChunkCapture):

- `call`: the whole entry; `session.init`: building a fresh state (a
  fresh state opens a new session id, a given `state=` continues the
  current one); `call.stage`: the log padded, the output buffer, the
  log's pinned staging;
- `chunk.load` (mark `load`: the call's first device work),
  `chunk.replay` (`scans`; marks `copied` after the input copies, `head`
  at the head of the captured graph, `replayed` after the replay) and
  `chunk.finish` (mark `cloned`: the call's last device work);
- `chunk.eager` (`scans`): a chunk of eager steps (the CPU, plain runs,
  a log's tail), host time only.

One thread records; a second thread's spans would nest into the first's.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import time
from collections import defaultdict

import torch

RING = 1 << 16    # records kept; the oldest drop first
POOL = 4096       # timing events a device keeps: made at its first mark

_ring: collections.deque = collections.deque(maxlen=RING)
_stack: list = []
_ids = itertools.count(1)
_counts = {"session": 0, "call": 0}
_clocks: dict = {}
_last = (None, None)    # the device of the last mark, and its clock
# a timing event's own methods, called past torch.cuda.Event's Python
# layer on the hot path
_EVENT = torch._C._CudaEventBase


class span:
    """A span of host time around a `with` block, recorded in the ring;
    `ids` are kept with the record (`session` and `call` override the ones
    the enclosing span passes down). The block gets the record."""

    __slots__ = ("name", "ids", "rec", "fn")

    def __init__(self, name: str, **ids):
        self.name, self.ids, self.fn = name, ids, None

    def __enter__(self) -> dict:
        if _stack:
            parent = _stack[-1]
            up = parent["id"], parent["session"], parent["call"]
        else:
            up = None, None, None
        rec = {"id": next(_ids), "name": self.name, "parent": up[0],
               "session": up[1], "call": up[2],
               "profiled": torch.autograd.profiler._is_profiler_enabled,
               "start_ns": time.perf_counter_ns(), "end_ns": None,
               "marks": {}}
        if self.ids:
            rec.update(self.ids)
        if rec["profiled"]:
            # a host event on the trace's clock, with no mirror among the
            # device's activities (record_function's user range has one)
            self.fn = torch._C._profiler._RecordFunctionFast(self.name)
            self.fn.__enter__()
        _ring.append(rec)
        _stack.append(rec)
        self.rec = rec
        return rec

    def __exit__(self, *exc):
        _stack.pop()
        self.rec["end_ns"] = time.perf_counter_ns()
        if self.fn is not None:
            self.fn.__exit__(*exc)
        return False


def call(fresh: bool) -> span:
    """The `call` span of an entry point: the next call number, and a new
    session where the entry builds a fresh state."""
    _counts["call"] += 1
    if fresh or _counts["session"] == 0:
        _counts["session"] += 1
    return span("call", session=_counts["session"], call=_counts["call"])


class _Clock:
    """One device's marks. A pooled mark waits in stream order (`pending`)
    and resolves against the last resolved one (`base`); where no event
    is free, the oldest waiting mark gives its event up and is lost. A
    graph's event waits in `graphs` with the pooled mark recorded before
    it, and is settled into an offset from that mark before the graph
    records it again."""

    def __init__(self, device):
        self.index = getattr(device, "index", None)
        self.top, self.cur = None, None
        self.made = False
        self.free: list = []
        self.pending: collections.deque = collections.deque()
        self.last = None
        self.graphs: dict = {}
        self.offsets: collections.deque = collections.deque(maxlen=POOL)
        self.base, self.base_us = None, 0.0

    def take(self):
        """A free event where none is left: POOL of them made at the first
        mark (each recorded once, which creates it); later the oldest
        waiting mark's, that mark lost."""
        if self.made and self.pending:
            ev = self.pending.popleft()[1]
            for event, (_, (_, ref_ev)) in list(self.graphs.items()):
                if ref_ev is ev:
                    del self.graphs[event]
            return ev
        for _ in range(1 if self.made else POOL):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(self.cur)
            self.free.append(ev)
        self.made = True
        return self.free.pop()

    def record(self, m):
        """A pooled mark on the device's current stream, taken once in each
        outermost span."""
        if self.top is not _stack[0]:
            self.top = _stack[0]
            self.cur = torch.cuda.current_stream(self.index)
        ev = self.free.pop() if self.free else self.take()
        _EVENT.record(ev, self.cur)
        self.pending.append((m, ev))
        self.last = (m, ev)

    def settle(self, event, force: bool):
        """The graph event's waiting mark as an offset from the mark before
        it, where the event has completed (so has that mark, earlier on
        the stream); lost if not and `force`."""
        m, (ref, ref_ev) = self.graphs[event]
        if _EVENT.query(event):
            self.offsets.append(
                (m, ref, 1e3 * _EVENT.elapsed_time(ref_ev, event)))
        elif not force:
            return
        del self.graphs[event]

    def resolve(self):
        """Give each completed mark its device time."""
        for event in list(self.graphs):
            self.settle(event, force=False)
        held = {id(ref_ev) for _, (_, ref_ev) in self.graphs.values()}
        while self.pending:
            m, ev = self.pending[0]
            if not ev.query():
                break
            self.pending.popleft()
            m[1] = (0.0 if self.base is None else
                    self.base_us + 1e3 * self.base.elapsed_time(ev))
            if self.base is not None and id(self.base) not in held:
                self.free.append(self.base)
            self.base, self.base_us = ev, m[1]
        waiting = [o for o in self.offsets if o[1][1] is None]
        for m, ref, off in self.offsets:
            if ref[1] is not None:
                m[1] = ref[1] + off
        self.offsets.clear()
        self.offsets.extend(waiting)


def mark(name: str, device, event=None):
    """A device mark `name` in the innermost open span: a timing event
    from `device`'s pool recorded on its current stream, or `event`, the
    timing event a CUDA graph records at its head (call this right before
    the replay). Outside a span it does nothing."""
    global _last
    if not _stack:
        return
    if _last[0] is device:
        clock = _last[1]
    else:
        clock = _clocks.get(device)
        if clock is None:
            clock = _clocks[device] = _Clock(device)
        _last = (device, clock)
    m = [time.perf_counter_ns(), None]
    if event is None:
        clock.record(m)
    else:
        if event in clock.graphs:
            clock.settle(event, force=True)
        if clock.last is None:
            return
        clock.graphs[event] = (m, clock.last)
    _stack[-1]["marks"][name] = m


def records() -> list:
    """The ring's records, oldest first, their completed marks resolved
    (`Event.query()` first: nothing waits for the card)."""
    for clock in _clocks.values():
        clock.resolve()
    return list(_ring)


def clear():
    """Empty the ring."""
    _ring.clear()


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
