"""map update: kernel 1 `ism` over every particle's update window in one
launch, against its roofline (benchmark/layers.py); one launch a scan,
the gate passed on the scans the step integrated."""

import torch

from benchmark import bounds
from benchmark.layers import roofline
from benchmark.reference.common import update_window_cells


def read(ctx):
    g, s, pf = ctx.cfg["grid"], ctx.cfg["sensor"], ctx.cfg["pf"]
    uwin = update_window_cells(g, s)
    elem = torch.empty((), dtype=getattr(torch, pf["map_dtype"])).element_size()
    return roofline(ctx, r"::update_ism_kernel\b", ctx.counts["updates"],
                    bounds.update_ism_work(pf["n_particles"], uwin * uwin,
                                           elem, s["n_beams"]))
