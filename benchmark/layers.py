"""Arithmetic the per-layer readers (benchmark/metrics/*.py) share.

A kernel's roofline share is the least time the work of the traced span
needs (benchmark/bounds.py: each launch whose gate passed counts its
cell's shapes, a launch whose gate was 0 its gate byte), over the device
time of all of that kernel's launches in the span, in percent. The
launches whose gate passed are counted by the program's step counters
over the span (`ctx.counts`). A reader that finds no such launch, or a
card with no entry in the peak table, returns None.
"""

from __future__ import annotations

from benchmark import bounds


def device_s(ops) -> float:
    return sum(e - s for _, s, e in ops) / 1e6


def roofline(ctx, pattern: str, passed: int, work):
    """Percent of the roofline of the kernels matching `pattern`, with
    `passed` launches whose gate passed, each needing `work` = (bytes,
    operations); None where nothing passed or the card is unknown."""
    tl = ctx.timeline
    if tl is None or passed <= 0:
        return None
    ops = tl.named(pattern)
    t = device_s(ops)
    if t <= 0:
        return None
    one = bounds.bound_s(*work, ctx.device_name)
    gate = bounds.bound_s(bounds.GATE_BYTES, 0, ctx.device_name)
    if one is None:
        return None
    idle = max(len(ops) - passed, 0)
    return 100.0 * (passed * one + idle * gate) / t


def per_scan(ctx, value):
    """`value` over the traced span's scans (None where the span has no
    scan or the trace no device operation)."""
    if ctx.timeline is None or not ctx.timeline.ops or ctx.scans_traced == 0:
        return None
    return value / ctx.scans_traced
