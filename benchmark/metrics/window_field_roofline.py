"""PF refine: kernel 6, every particle's likelihood field over its scan
window in one launch, against its roofline (benchmark/layers.py); one
launch a scan, the gate passed on the scans the step refined."""

import torch

from benchmark import bounds
from benchmark.layers import roofline
from benchmark.reference.common import blur_halo_cells, scan_window_cells


def read(ctx):
    g, s, m, pf = (ctx.cfg[k] for k in ("grid", "sensor", "matcher", "pf"))
    win = scan_window_cells(g, s, m)
    n_taps = 2 * blur_halo_cells(m, g["resolution"]) + 1
    elem = torch.empty((), dtype=getattr(torch, pf["map_dtype"])).element_size()
    out = 2 if m["score_bf16"] else 4
    return roofline(ctx, r"::window_field\w*_kernel\b", ctx.counts["refines"],
                    bounds.window_field_work(pf["n_particles"], win, elem,
                                             out, n_taps))
