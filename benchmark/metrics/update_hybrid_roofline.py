"""map update: kernel 1 `hybrid` in place on the update window, against
its roofline (benchmark/layers.py); one launch a scan, the gate passed on
the scans the step integrated."""

from benchmark import bounds
from benchmark.layers import roofline
from benchmark.reference.common import update_window_cells


def read(ctx):
    g, s, m = ctx.cfg["grid"], ctx.cfg["sensor"], ctx.cfg["matcher"]
    uwin = update_window_cells(g, s, m)
    return roofline(ctx, r"::update_hybrid_kernel\b", ctx.counts["updates"],
                    bounds.update_hybrid_work(uwin * uwin, s["n_beams"]))
