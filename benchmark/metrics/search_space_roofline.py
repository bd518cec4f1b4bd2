"""matcher: kernel 3, the search space rebuilt in place on the update
window's kept cells, against its roofline (benchmark/layers.py); one
launch a scan, the gate passed on the scans the step integrated."""

from benchmark import bounds
from benchmark.layers import roofline
from benchmark.reference.common import blur_halo_cells, update_window_cells


def read(ctx):
    g, s, m = ctx.cfg["grid"], ctx.cfg["sensor"], ctx.cfg["matcher"]
    uwin = update_window_cells(g, s, m)
    halo = blur_halo_cells(m, g["resolution"])
    return roofline(ctx, r"::search_space_kernel\b", ctx.counts["updates"],
                    bounds.search_space_work(uwin * uwin,
                                             (uwin - 2 * halo) ** 2,
                                             2 * halo + 1))
