"""Plain reference of the scan-matching frontend, in PyTorch, for the
benchmark's check of what the timed path produced.

The semantics are those of slam2d_tpu_torch/run/frontend.py:_step with
the hybrid log-odds update and the gather scorer, as the frontend
configuration resolves them: odometry prior, motion gates, the coarse
(max-pooled) and fine (bilinear) correlative match on the search space's
scan window, the update of the map's update window (a free wedge under
each beam, l_occ at each hit's floor-exact endpoint cell) and the search
space rebuilt on the window's kept cells. The code is a frozen copy of
the program's plain versions at commit
fe37ab964ea616f84f82d44417eea1bff9015b6b (match/correlative.py:
match_scan, coarse_space, endpoint_positions; ops/score.py:
score_window_plain; ops/update.py: hybrid_tables, update_hybrid_plain;
ops/search_space.py: search_space_window_plain), branching on the
gates on the host. It imports nothing of the program.

A filter amplifies last bits, so the check follows the program scan by
scan: each scan's prior is the program's previous pose composed with the
odometry step, and the map is updated at the program's pose. Within a
chunk the map and its search space are the reference's own, from the
program's map at the chunk's start (or the empty map at a session's
start). `dtype` computes the reference in a lower precision (the
control): the map, its search space and the candidates' scores are
rounded to it wherever they are stored.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference import common as C


class FrontendReference:
    """The frontend of one configuration (a config file's dict)."""

    def __init__(self, cfg: dict, device, dtype=torch.float32):
        self.cfg = cfg
        self.grid, self.sensor = cfg["grid"], cfg["sensor"]
        self.m, self.fe = cfg["matcher"], cfg["frontend"]
        if self.grid["update_impl"] not in ("auto", "pallas_hybrid"):
            raise NotImplementedError("the reference holds the hybrid update")
        if self.m["score_impl"] not in ("auto", "gather", "pallas"):
            raise NotImplementedError("the reference holds the gather scorer")
        if self.sensor["fov_rad"] > math.pi + 1e-6:
            raise NotImplementedError("fields of view past pi")
        self.device = torch.device(device)
        self.dtype = dtype
        res = self.grid["resolution"]
        halo = C.blur_halo_cells(self.m, res)
        self.taps = C.gaussian_kernel_1d(self.m["sigma_m"] / res, halo)
        self.margin = halo
        self.angles = C.beam_angles(self.sensor, self.device)
        self.dthetas = torch.as_tensor(self._theta_offsets(),
                                       device=self.device)

    # -- state ------------------------------------------------------------

    def fresh(self, odom0):
        """A session's start: the empty map, the pose at odom0."""
        H, W = self.grid["height"], self.grid["width"]
        f32 = dict(dtype=torch.float32, device=self.device)
        pose = torch.as_tensor(np.asarray(odom0, np.float32),
                               device=self.device)
        return self._state(torch.zeros((H, W), **f32), pose, pose.clone(),
                           torch.zeros((), **f32), pose.clone(),
                           torch.zeros(2, **f32))

    def resume(self, logodds, pose, prev_odom, dist, last_map_pose,
               since_match):
        """The program's state at a chunk's start; the search space is
        worked out again from the map."""
        return self._state(*(t.detach().to(self.device, torch.float32)
                             .clone() for t in (logodds, pose, prev_odom,
                                                dist, last_map_pose,
                                                since_match)))

    def _state(self, logodds, pose, prev_odom, dist, last_map_pose,
               since_match):
        logodds = self._store(logodds)
        return dict(logodds=logodds, S=self._space(logodds), pose=pose,
                    prev_odom=prev_odom, dist=dist,
                    last_map_pose=last_map_pose, since_match=since_match)

    def _store(self, x):
        """`x` rounded to the reference's precision, held in float32."""
        return x.to(self.dtype).to(torch.float32)

    def _space(self, logodds):
        m = self.m
        return self._store(C.search_space_plain(
            logodds, self.taps, m["occ_evidence_sat"], m["free_threshold"],
            m["free_penalty"]))

    # -- one scan ------------------------------------------------------------

    def step(self, st, odom, ranges, prev_pose=None, update_pose=None):
        """One scan: (pose [3], score). `prev_pose` (the program's pose of
        the previous scan) replaces the state's pose for the prior, and
        `update_pose` (the program's pose of this scan) places the map
        update; None uses the reference's own."""
        fe = self.fe
        delta = C.between(st["prev_odom"], odom)
        step_len = torch.hypot(delta[0], delta[1])
        prior = C.compose(st["pose"] if prev_pose is None else prev_pose,
                          delta)
        in_boot = bool(st["dist"] < fe["bootstrap_dist"])
        since_m = st["since_match"] + torch.stack(
            [step_len, torch.abs(C.wrap_angle(delta[2]))])
        do_match = bool((since_m[0] >= fe["match_min_motion"])
                        | (since_m[1] >= fe["match_min_rot"]))
        do_match = do_match and not in_boot
        if do_match:
            pose, score = self.match(st["S"], ranges, prior)
            since_m = torch.zeros_like(since_m)
        else:
            pose, score = prior, torch.full_like(prior[0], -1.0)
        st["dist"] = st["dist"] + step_len
        upose = pose if update_pose is None else update_pose
        lmp = st["last_map_pose"]
        moved = torch.hypot(upose[0] - lmp[0], upose[1] - lmp[1])
        rotated = torch.abs(C.wrap_angle(upose[2] - lmp[2]))
        do_update = in_boot or bool(
            (moved >= fe["map_update_min_motion"])
            | (rotated >= fe["map_update_min_rot"]))
        if do_update:
            self.update(st, upose, ranges)
            st["last_map_pose"] = upose
        st["pose"], st["prev_odom"], st["since_match"] = pose, odom, since_m
        return pose, score

    # -- the map update ----------------------------------------------------

    def update(self, st, pose, ranges):
        """The hybrid update of the update window and the window's search
        space, in place."""
        g, sen = self.grid, self.sensor
        H, W = g["height"], g["width"]
        uwin = C.update_window_cells(g, sen, self.m)
        ox, oy = C.origin_xy(g)
        if uwin < min(H, W):
            origin = C.window_origin_t(C.world_to_cell(pose[:2], g), uwin,
                                       H, W)
        else:
            origin = torch.zeros(2, dtype=torch.int32, device=self.device)
        win = C.take_window(st["logodds"], origin, uwin)
        o = tuple(C.window_origin_xy_t(ox, oy, g["resolution"], origin))
        new = self._store(update_hybrid_plain(
            win, pose, ranges, self.angles, origin_xy=o,
            resolution=g["resolution"], step=C.beam_step(sen),
            angle_min=sen["angle_min"], min_range=sen["min_range"],
            max_range=sen["max_range"], l_free=g["l_free"],
            l_occ=g["l_occ"], l_clamp=g["l_clamp"]))
        C.put_window(st["logodds"], new, origin)
        margin = self.margin if uwin < min(H, W) else 0
        old = C.take_window(st["S"], origin, uwin)
        keep = C.blur_exact_keep(origin, uwin, (H, W), margin)
        C.put_window(st["S"], torch.where(keep, self._space(new), old),
                     origin)

    # -- the match -------------------------------------------------------------

    def _theta_offsets(self):
        m = self.m
        if m["n_theta"] <= 1:
            return np.zeros(1, np.float32)
        return np.linspace(-m["search_theta"], m["search_theta"],
                           m["n_theta"]).astype(np.float32)

    def match(self, S, ranges, prior):
        """The coarse-to-fine correlative match: (pose [3], raw score)."""
        g, m, sen = self.grid, self.m, self.sensor
        H, W = g["height"], g["width"]
        res = g["resolution"]
        win = C.scan_window_cells(g, sen, m)
        ox, oy = C.origin_xy(g)
        if win < min(H, W):
            origin = C.window_origin_t(C.world_to_cell(prior[:2], g), win,
                                       H, W)
            Sw = C.take_window(S, origin, win)
            org = C.window_origin_xy_t(ox, oy, res, origin)
        else:
            Sw, org = S, (ox, oy)
        f = m["coarse_factor"]
        pts, valid = C.scan_endpoints_local(ranges, sen)
        dthetas = self.dthetas
        nT = dthetas.shape[0]

        def penalty(dx_m, dy_m, dth):
            return (m["prior_theta_weight"] * (dth ** 2)[:, None, None]
                    + m["prior_xy_weight"] * (dy_m ** 2)[None, :, None]
                    + m["prior_xy_weight"] * (dx_m ** 2)[None, None, :])

        r_fine = int(round(m["search_xy"] / res))
        zero = torch.zeros((), dtype=torch.float32, device=self.device)
        if r_fine <= f:
            cdx = cdy = zero
            prior2, r_pass, dth_fine = prior, r_fine, dthetas
        else:
            r_c = int(math.ceil(r_fine / f))
            cs = res * f
            sc = self._store(score_offsets(coarse_space(Sw, f), prior, pts,
                                           valid, dthetas, r_c, cs, org,
                                           bilinear=False))
            off_m = torch.arange(-r_c, r_c + 1, dtype=torch.int32,
                                 device=self.device).to(torch.float32) * cs
            sc = sc - penalty(off_m, off_m, dthetas)
            tc, rc, cc = C.argmax3(sc)
            cdx, cdy = off_m[cc], off_m[rc]
            prior2 = torch.stack([prior[0] + cdx, prior[1] + cdy, prior[2]])
            r_pass = f
            ftb = m["fine_theta_bins"]
            if 0 <= ftb and 2 * ftb + 1 < nT:
                nft = 2 * ftb + 1
                t0 = min(max(tc - ftb, 0), nT - nft)
                dth_fine = dthetas[t0:t0 + nft]
            else:
                dth_fine = dthetas
        sf_raw = self._store(score_offsets(Sw, prior2, pts, valid, dth_fine,
                                           r_pass, res, org, bilinear=True))
        fine_m = torch.arange(-r_pass, r_pass + 1, dtype=torch.int32,
                              device=self.device).to(torch.float32) * res
        sf = sf_raw - penalty(cdx + fine_m, cdy + fine_m, dth_fine)
        tf, rf, cf = C.argmax3(sf)
        best = sf_raw[tf, rf, cf]

        def subpeak(idx, along):
            n = sf.shape[along]
            i0 = min(max(idx, 1), n - 2)
            at = [tf, rf, cf]
            sm, s0, sp = list(at), list(at), list(at)
            sm[along], s0[along], sp[along] = i0 - 1, i0, i0 + 1
            vm, v0, vp = sf[tuple(sm)], sf[tuple(s0)], sf[tuple(sp)]
            denom = vm - 2.0 * v0 + vp
            d = torch.where(torch.abs(denom) > 1e-9,
                            0.5 * (vm - vp) / denom, 0.0)
            d = torch.clamp(d, -0.5, 0.5)
            return d if 1 <= idx <= n - 2 else torch.zeros_like(d)

        dth_step = float(2 * m["search_theta"] / max(m["n_theta"] - 1, 1))
        sub_t = subpeak(tf, 0) * dth_step
        sub_r = subpeak(rf, 1) * res
        sub_c = subpeak(cf, 2) * res
        pose = torch.stack([
            prior2[0] + fine_m[cf] + sub_c,
            prior2[1] + fine_m[rf] + sub_r,
            C.wrap_angle(prior[2] + dth_fine[tf] + sub_t),
        ])
        pose = torch.where(best >= m["min_score"], pose, prior)
        return pose, best


def coarse_space(S, factor: int):
    """Max-pooled search space; a ragged edge padded with -1e9."""
    H, W = S.shape[-2:]
    ph, pw = (-H) % factor, (-W) % factor
    if ph or pw:
        S = torch.nn.functional.pad(S, (0, pw, 0, ph), value=-1e9)
        H, W = S.shape[-2:]
    return S.reshape(*S.shape[:-2], H // factor, factor, W // factor,
                     factor).amax(dim=(-3, -1))


def score_offsets(S, prior, pts_local, valid, dthetas, radius: int,
                  cell_size: float, origin_xy, bilinear: bool):
    """Scores [T, 2r+1, 2r+1]: the mean over valid beams of S at each
    candidate's endpoints (bilinear, or the rounded cell)."""
    theta = prior[2] + dthetas
    pts = C.rotate_points(theta, pts_local[None, :, :])
    inv_cell = C.inv_f32(cell_size)
    pos_col = (pts[..., 0] + prior[0] - origin_xy[0]) * inv_cell - 0.5
    pos_row = (pts[..., 1] + prior[1] - origin_xy[1]) * inv_cell - 0.5
    pos_col = torch.where(valid[None, :], pos_col, 0.0).contiguous()
    pos_row = torch.where(valid[None, :], pos_row, 0.0).contiguous()
    return score_window_plain(S, pos_row, pos_col, valid, radius, bilinear)


def score_window_plain(S, pos_row, pos_col, valid, radius: int,
                       bilinear: bool):
    """The gather scorer: each tap outside S masked on its own."""
    H, W = S.shape
    offs = torch.arange(-radius, radius + 1, dtype=torch.int32,
                        device=S.device)
    flat = S.reshape(-1)

    def gather_sum(base_row, base_col, beam_w):
        rows = base_row[:, None, :] + offs[None, :, None]
        cols = base_col[:, None, :] + offs[None, :, None]
        in_r = (rows >= 0) & (rows < H)
        in_c = (cols >= 0) & (cols < W)
        rows = torch.clamp(rows, 0, H - 1)
        cols = torch.clamp(cols, 0, W - 1)
        idx = rows[:, :, None, :].long() * W + cols[:, None, :, :].long()
        vals = flat[idx]
        mask = in_r[:, :, None, :] & in_c[:, None, :, :]
        w = torch.where(mask, beam_w[:, None, None, :], 0.0)
        return torch.sum(vals * w, dim=-1)

    vweight = valid.to(torch.float32)[None, :]
    denom = torch.clamp(torch.sum(valid.to(torch.float32)), min=1.0)
    if not bilinear:
        base_col = torch.round(pos_col).to(torch.int32)
        base_row = torch.round(pos_row).to(torch.int32)
        return gather_sum(base_row, base_col,
                          vweight * torch.ones_like(pos_col)) / denom
    c0, r0 = torch.floor(pos_col), torch.floor(pos_row)
    fc, fr = pos_col - c0, pos_row - r0
    c0, r0 = c0.to(torch.int32), r0.to(torch.int32)
    acc = gather_sum(r0, c0, vweight * (1 - fr) * (1 - fc))
    acc += gather_sum(r0, c0 + 1, vweight * (1 - fr) * fc)
    acc += gather_sum(r0 + 1, c0, vweight * fr * (1 - fc))
    acc += gather_sum(r0 + 1, c0 + 1, vweight * fr * fc)
    return acc / denom


def hybrid_tables(pose, ranges, angles, *, origin_xy, shape, resolution,
                  min_range, max_range):
    """(rmin3 [B], ends [B]): each beam's and its neighbours' least valid
    range, and each hit's floor-exact endpoint cell in the window."""
    H, W = shape
    ox, oy = origin_xy
    r = torch.clamp(ranges, 0.0, max_range)
    valid = (ranges > min_range) & torch.isfinite(ranges)
    hit = valid & (ranges < max_range)
    rv = torch.where(valid, r, math.inf)
    rmin3 = torch.minimum(rv, torch.minimum(
        torch.cat([rv[:1], rv[:-1]]), torch.cat([rv[1:], rv[-1:]])))
    rmin3 = torch.where(valid & torch.isfinite(rmin3), rmin3, -1.0)
    a = angles + pose[..., 2:3]
    inv_res = C.inv_f32(resolution)
    ecol = torch.floor((pose[..., 0:1] + torch.cos(a) * r - ox) * inv_res)
    erow = torch.floor((pose[..., 1:2] + torch.sin(a) * r - oy) * inv_res)
    on = hit & (erow >= 0) & (erow < H) & (ecol >= 0) & (ecol < W)
    ends = torch.where(on, erow * W + ecol, -1.0).to(torch.int64)
    return rmin3, ends


def update_hybrid_plain(grid, pose, ranges, angles, *, origin_xy, resolution,
                        step, angle_min, min_range, max_range, l_free, l_occ,
                        l_clamp):
    """The hybrid update of a window: a cell is free where a beam's slot
    holds its bearing and it lies nearer than the beam's neighbourhood's
    least range less a cell; it gains l_occ for each hit ending in it."""
    H, W = grid.shape
    B = ranges.shape[0]
    dev = grid.device
    ox, oy = origin_xy
    rmin3, ends = hybrid_tables(
        pose, ranges, angles, origin_xy=origin_xy, shape=(H, W),
        resolution=resolution, min_range=min_range, max_range=max_range)
    col = torch.arange(W, dtype=torch.float32, device=dev)
    row = torch.arange(H, dtype=torch.float32, device=dev)
    cx = (C.fma_f32(col + 0.5, resolution, ox) - pose[0])[None, :].expand(H, W)
    cy = (C.fma_f32(row + 0.5, resolution, oy) - pose[1])[:, None].expand(H, W)
    d = torch.sqrt(cx * cx + cy * cy)
    phi = C.atan2_ref(cy, cx) - pose[2] - angle_min
    phi = torch.remainder(phi + math.pi, 2 * math.pi) - math.pi
    k0 = torch.floor(phi / step)
    free = torch.zeros((H, W), dtype=torch.bool, device=dev)
    for k in (k0, k0 + 1):
        kb = torch.clamp(k, 0, B - 1).to(torch.int64)
        ab = kb.to(torch.float32) * step
        free |= ((k >= 0) & (k <= B - 1)
                 & (torch.abs(phi - ab) <= 0.5 * step)
                 & (d < rmin3[kb] - resolution))
    on = ends >= 0
    count = torch.zeros(H * W, dtype=torch.float32, device=dev)
    count.index_put_((torch.where(on, ends, 0),), on.to(torch.float32),
                     accumulate=True)
    upd = (l_free * free.to(torch.float32) + l_occ * count.view(H, W)) * 1.0
    return torch.clamp(grid + upd, -l_clamp, l_clamp)
