"""PF resample: kernel 4, the maps' rows gathered into the scratch stack
and copied back, two launches a scan, against their roofline
(benchmark/layers.py). Both launches pass on the scans that resampled.
The ancestors are not read back, so the first launch is counted at its
least, one distinct row; the copy back reads P."""

import torch

from benchmark import bounds
from benchmark.layers import roofline


def read(ctx):
    g, pf = ctx.cfg["grid"], ctx.cfg["pf"]
    P = pf["n_particles"]
    elem = torch.empty((), dtype=getattr(torch, pf["map_dtype"])).element_size()
    row = g["height"] * g["width"] * elem
    gather = bounds.gather_rows_work(1, P, row)
    back = bounds.gather_rows_work(P, P, row)
    n = ctx.counts["resamples"]
    # a resample's pair counted as two launches of their mean work
    work = ((gather[0] + back[0]) / 2, 0)
    return roofline(ctx, r"::gather_rows\w*_kernel\b", 2 * n, work)
