"""The program's own spans and device marks
(slam2d_tpu_torch/utils/profiling.py), as the per-layer readers of
`source: program_span` read them.

Each entry call (`run_frontend`, `run_fastslam`) is one `call` span with
its children; on CUDA its chunk spans carry device marks in stream order:
`load` (the call's first device work), per replay `copied` (after the
inputs' copies), `head` (the head of the captured graph), `replayed`, and
`cloned` (the call's last device work), each in microseconds on one
device clock. A reader uses the calls recorded with the profiler off and
with every device mark resolved (none on the CPU), after the process's
first session (the harness's warm-up), and returns None where it finds
none. A program without the recorder (no `records`) gives no calls.
"""

from __future__ import annotations

import statistics


def program_records():
    """The program's span records, or None where it records none."""
    from slam2d_tpu_torch.utils import profiling
    fn = getattr(profiling, "records", None)
    return fn() if fn is not None else None


class Call:
    """One entry call: its `call` record, its descendants (`spans`, in
    start order), and the device times of its marks."""

    def __init__(self, root, spans):
        self.root, self.spans = root, spans
        self.number, self.session = root["call"], root["session"]
        times = [m[1] for s in [root, *spans] for m in s["marks"].values()]
        # a call with a lost or unresolved mark is left out whole
        whole = times and None not in times
        self.first = min(times) if whole else None
        self.last = max(times) if whole else None

    def named(self, name):
        return [s for s in self.spans if s["name"] == name]

    def replays(self):
        """(scans, copied, head, replayed) device times of each replay
        whose three marks resolved."""
        out = []
        for s in self.named("chunk.replay"):
            m = [s["marks"].get(k, (None, None))[1]
                 for k in ("copied", "head", "replayed")]
            if None not in m:
                out.append((s["scans"], *m))
        return out

    def init_ns(self):
        return sum(s["end_ns"] - s["start_ns"]
                   for s in self.named("session.init"))


def calls(records=None):
    """The unprofiled calls with all their marks, after the first
    session, in call order; None where there are none."""
    records = program_records() if records is None else records
    if not records:
        return None
    roots, spans, profiled = {}, {}, set()
    for r in records:
        c = r.get("call")
        if c is None:
            continue
        if r["profiled"]:
            profiled.add(c)
        if r["name"] == "call" and r["parent"] is None:
            roots[c] = r
        else:
            spans.setdefault(c, []).append(r)
    sessions = [r["session"] for r in roots.values()]
    if not sessions:
        return None
    first = min(sessions)
    out = [Call(roots[c], spans.get(c, [])) for c in sorted(roots)
           if c not in profiled and roots[c]["session"] != first]
    out = [c for c in out if c.first is not None]
    return out or None


def runs(cs):
    """The calls split into runs of consecutive call numbers (a profiled
    or unmarked call between two breaks the run)."""
    out = []
    for c in cs:
        if out and out[-1][-1].number + 1 == c.number:
            out[-1].append(c)
        else:
            out.append([c])
    return out


def handoffs(cs, same_session=True):
    """Device idle from each call's last mark to the next call's first,
    over consecutive calls (of one session, unless `same_session` is
    False)."""
    out = []
    for run in runs(cs):
        for a, b in zip(run[:-1], run[1:]):
            if a.session == b.session or not same_session:
                out.append(b.first - a.last)
    return out


def median(values):
    return statistics.median(values) if values else None
