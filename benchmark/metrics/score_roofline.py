"""matcher: kernel 2, the correlative scorer, two launches a scan (the
coarse pass over the max-pooled window and the fine bilinear pass),
against its roofline (benchmark/layers.py). Both pass on the scans the
step matched. A pass's work depends on the cells under its beams' taps:
it is counted from the traced span's matched scans, the coarse pass at
the scan's prior (the program's previous pose and the odometry step) and
the fine pass at the matched pose (its window is centred within a coarse
cell of it), over their mean."""

import math

import numpy as np
import torch

from benchmark import bounds
from benchmark.layers import roofline
from benchmark.reference import common as C


def _positions(pose, pts, valid, thetas, cell, org):
    th = pose[2] + thetas
    p = C.rotate_points(th, pts[None, :, :])
    inv = C.inv_f32(cell)
    col = (p[..., 0] + pose[0] - org[0]) * inv - 0.5
    row = (p[..., 1] + pose[1] - org[1]) * inv - 0.5
    return (torch.where(valid[None, :], row, 0.0),
            torch.where(valid[None, :], col, 0.0))


def _scan_work(cfg, prior, pose, ranges):
    g, s, m = cfg["grid"], cfg["sensor"], cfg["matcher"]
    H, W, res = g["height"], g["width"], g["resolution"]
    win = C.scan_window_cells(g, s, m)
    f = m["coarse_factor"]
    r_fine = int(round(m["search_xy"] / res))
    n_t = m["n_theta"]
    thetas = torch.as_tensor(np.linspace(-m["search_theta"], m["search_theta"],
                                         n_t).astype(np.float32))
    pts, valid = C.scan_endpoints_local(ranges, s)
    ox, oy = C.origin_xy(g)
    origin = C.window_origin_t(C.world_to_cell(prior[:2], g), win, H, W)
    org = C.window_origin_xy_t(ox, oy, res, origin)
    work = []
    if r_fine > f:
        r_c = int(math.ceil(r_fine / f))
        pr, pc = _positions(prior, pts, valid, thetas, res * f, org)
        work.append(bounds.score_work((win // f, win // f), pr, pc, valid,
                                      2 * r_c + 1, False))
        ftb = m["fine_theta_bins"]
        step = 2 * m["search_theta"] / max(n_t - 1, 1)
        fine = torch.arange(-ftb, ftb + 1, dtype=torch.float32) * step
        r_pass = f
    else:
        fine, r_pass = thetas, r_fine
    pr, pc = _positions(pose, pts, valid, fine, res, org)
    work.append(bounds.score_work((win, win), pr, pc, valid, 2 * r_pass + 1,
                                  True))
    return work


def read(ctx):
    passed = 2 * ctx.counts["matches"]
    if ctx.timeline is None or passed <= 0:
        return None
    log, K = ctx.system.log, ctx.system.K
    works = []
    prev_chunk = None
    for c, out in ctx.traced:
        out = torch.as_tensor(np.asarray(out, np.float32))
        for k in range(len(out)):
            if out[k, 3] == -1.0:
                continue
            if k > 0:
                prev = out[k - 1, :3]
            elif prev_chunk is not None and prev_chunk[0] == c - 1:
                prev = prev_chunk[1][-1, :3]
            else:
                continue
            t = c * K + k
            o0 = torch.as_tensor(log["odom"][t - 1])
            o1 = torch.as_tensor(log["odom"][t])
            prior = C.compose(prev, C.between(o0, o1))
            works.extend(_scan_work(ctx.cfg, prior, out[k, :3],
                                    torch.as_tensor(log["ranges"][t])))
        prev_chunk = (c, out)
    if not works:
        return None
    mean = (sum(w[0] for w in works) / len(works),
            sum(w[1] for w in works) / len(works))
    return roofline(ctx, r"::score_kernel\b", passed, mean)
