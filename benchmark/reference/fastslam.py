"""Plain reference of FastSLAM with the shared-anchor refine and the
per-particle inverse-sensor-model update, in PyTorch, for the benchmark's
check of what the timed path produced.

The semantics are those of slam2d_tpu_torch/pf/fastslam.py:fastslam_step
as FastSLAM-100's configuration resolves it: the odometry proposal with
the given noise; on a refine, every particle's candidates anchored on its
prior's cell and one global theta grid, scored by one float32 product of
the particles' likelihood fields with the scan's shifted endpoint splats,
the motion prior, the argmax and its sub-cell peak, the weights
renormalised; on an update, each particle's update window integrated by
the inverse sensor model (a free wedge under each beam, l_occ on each
hit's arc); systematic resampling on the N_eff trigger. The code is a
frozen copy of the program's plain versions at commit
fe37ab964ea616f84f82d44417eea1bff9015b6b (pf/fastslam.py,
pf/shared_refine.py, match/correlative.py: splat_inputs, splat_image;
ops/field.py: unclamped_windows, window_field_plain; ops/stack.py:
shift_stack_plain; ops/update.py: window_origins, ism_cell_polar,
update_ism_plain), branching on the gates on the host. It imports nothing
of the program. The product runs with TF32 off.

A particle filter amplifies last bits, and only a chunk's start state is
handed over by the program, so the check runs a chunk's steps from the
program's state at its start with the program's draws. `low` computes
the reference in a lower precision than the configuration's bfloat16
(the control): every map write, the particles' fields and the scan's
splats are rounded to it.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import common as C

FIELDS = ("logodds", "poses", "log_w", "prev_odom", "dist", "since_update",
          "since_match")


class FastSlamReference:
    """FastSLAM of one configuration (a config file's dict)."""

    def __init__(self, cfg: dict, device, low=None):
        self.cfg = cfg
        self.grid, self.sensor = cfg["grid"], cfg["sensor"]
        self.m, self.fe, self.pf = cfg["matcher"], cfg["frontend"], cfg["pf"]
        pf, m = self.pf, self.m
        overrides = ("refine_xy", "refine_theta", "refine_n_theta",
                     "refine_prior_weight")
        if any(pf[k] is not None for k in overrides):
            raise NotImplementedError("refine overrides")
        shared = (pf["refine_mode"] == "shared" or (
            pf["refine_mode"] == "auto"
            and pf["n_particles"] >= pf["refine_shared_min_particles"]
            and m["n_theta"] > 1))
        per_particle_update = (pf["update_mode"] == "per_particle" or (
            pf["update_mode"] == "auto"
            and pf["n_particles"] < pf["update_shared_min_particles"]))
        if not (shared and per_particle_update
                and self.grid["update_impl"] in ("auto", "pallas")):
            raise NotImplementedError(
                "the reference holds the shared refine and the per-particle "
                "ISM update")
        self.device = torch.device(device)
        self.map_dtype = getattr(torch, pf["map_dtype"])
        self.low = low
        res = self.grid["resolution"]
        self.taps = C.gaussian_kernel_1d(m["sigma_m"] / res,
                                         C.blur_halo_cells(m, res))
        self.noise_scale = torch.tensor(
            [pf["noise_xy"], pf["noise_xy"], pf["noise_theta"]],
            dtype=torch.float32, device=self.device)

    # -- state ------------------------------------------------------------

    def fresh(self, odom0):
        P = self.pf["n_particles"]
        g = self.grid
        f32 = dict(dtype=torch.float32, device=self.device)
        pose = torch.as_tensor(np.asarray(odom0, np.float32),
                               device=self.device)
        return dict(
            logodds=torch.zeros((P, g["height"], g["width"]),
                                dtype=self.map_dtype, device=self.device),
            poses=pose[None, :].repeat(P, 1), log_w=torch.zeros(P, **f32),
            prev_odom=pose.clone(), dist=torch.zeros((), **f32),
            since_update=torch.full((), float("inf"), **f32),
            since_match=torch.zeros((), **f32))

    def resume(self, state: dict) -> dict:
        """The program's state at a chunk's start (its fields by name),
        copied."""
        return {k: state[k].detach().to(self.device).clone()
                for k in FIELDS}

    # -- one scan ------------------------------------------------------------

    def step(self, st, odom, ranges, noise, u):
        """One scan from `st` (updated in place): (best pose [3], N_eff,
        best score), with the proposal's standard normal `noise` [P, 3]
        and the resample's uniform `u`."""
        fe, pf = self.fe, self.pf
        P = pf["n_particles"]
        delta = C.between(st["prev_odom"], odom)
        step_len = torch.hypot(delta[0], delta[1])
        rot_equiv = torch.abs(C.wrap_angle(delta[2])) * (
            fe["match_min_motion"] / max(fe["match_min_rot"], 1e-6))
        since_m = st["since_match"] + step_len + rot_equiv
        since = st["since_update"] + step_len
        in_boot = bool(st["dist"] < fe["bootstrap_dist"])
        do_refine = (not in_boot) and bool(since_m >= fe["match_min_motion"])
        do_update = in_boot or bool(since >= fe["map_update_min_motion"])

        proposal = C.compose(st["poses"],
                             delta[None, :] + noise * self.noise_scale)
        poses = proposal if in_boot else C.compose(st["poses"],
                                                   delta[None, :])
        log_w = st["log_w"]
        scores = torch.full((P,), -1.0, dtype=torch.float32,
                            device=self.device)
        if do_refine:
            poses, scores = self.refine(st["logodds"], ranges, proposal)
            log_w = _normalized(log_w + pf["weight_sharpness"] * scores)
            since_m = torch.zeros_like(since_m)
        logodds = st["logodds"]
        if do_update:
            self.update(logodds, poses, ranges)
            since = torch.zeros_like(since)
        n_eff = effective_sample_size(log_w)
        if do_refine and bool(n_eff < pf["resample_threshold"] * P):
            anc = systematic_ancestors(log_w, u).to(torch.int64)
            logodds = logodds.index_select(0, anc)
            poses = poses.index_select(0, anc)
            log_w = torch.full_like(
                log_w, -float(np.log(np.float32(P), dtype=np.float32)))
        st.update(logodds=logodds, poses=poses, log_w=log_w, prev_odom=odom,
                  dist=st["dist"] + step_len, since_update=since,
                  since_match=since_m)
        best = int(torch.argmax(log_w))
        return poses[best], n_eff, scores[best]

    # -- the shared refine ---------------------------------------------------

    def refine(self, grids, ranges, priors):
        """(poses [P, 3], raw scores [P]) of every particle's refine."""
        g, m, sen, pf = self.grid, self.m, self.sensor, self.pf
        res = g["resolution"]
        P = grids.shape[0]
        win = C.scan_window_cells(g, sen, m)
        r_fine = int(round(m["search_xy"] / res))
        R = Cc = 2 * r_fine + 1
        pad = pf["refine_theta_pad"]
        G = m["n_theta"] + 2 * pad
        dth_step = 2.0 * m["search_theta"] / (m["n_theta"] - 1)
        cdtype = torch.bfloat16 if m["score_bf16"] else torch.float32
        _, valid = C.scan_endpoints_local(ranges, sen)
        denom = torch.clamp(valid.to(torch.float32).sum(), min=1.0)
        inv_p = C.inv_f32(P)
        theta_ref = torch.atan2(torch.sin(priors[:, 2]).sum() * inv_p,
                                torch.cos(priors[:, 2]).sum() * inv_p)
        dthg = (torch.arange(G, dtype=torch.float32, device=self.device)
                - (G - 1) / 2.0) * float(np.float32(dth_step))
        thetas = theta_ref + dthg
        E = self._low(endpoint_splat(ranges, sen, thetas, win, R, Cc, res,
                                     cdtype))
        stack = shift_stack_plain(E, R, Cc).reshape(G * R * Cc, win * win)
        center = C.world_to_cell(priors[:, :2], g)
        origins, anchors = center - win // 2, C.cell_center_world(center, g)
        thr = m["free_threshold"]
        Sp = window_field_plain(
            grids, origins, win, self.taps, 1.0 / m["occ_evidence_sat"],
            math.log(thr / (1.0 - thr)), m["free_penalty"], cdtype)
        Sp = self._low(Sp)
        prec = torch.get_float32_matmul_precision()
        torch.set_float32_matmul_precision("highest")
        try:
            raw = (Sp.reshape(P, win * win).to(torch.float32)
                   @ stack.to(torch.float32).T) / denom
        finally:
            torch.set_float32_matmul_precision(prec)
        raw = raw.reshape(P, G, R, Cc)

        ra, ca = R // 2, Cc // 2
        off_r = (torch.arange(R, dtype=torch.float32, device=self.device)
                 - ra) * res
        off_c = (torch.arange(Cc, dtype=torch.float32, device=self.device)
                 - ca) * res
        dx = anchors[:, 0:1] + off_c[None, :] - priors[:, 0:1]
        dy = anchors[:, 1:2] + off_r[None, :] - priors[:, 1:2]
        dth = C.wrap_angle(thetas[None, :] - priors[:, 2:3])
        pen = (m["prior_theta_weight"] * (dth * dth)[:, :, None, None]
               + m["prior_xy_weight"] * (dy * dy)[:, None, :, None]
               + m["prior_xy_weight"] * (dx * dx)[:, None, None, :])
        in_range = (torch.abs(dth)
                    <= m["search_theta"] + 0.5 * dth_step + 1e-6)
        sf = raw - pen - torch.where(in_range, 0.0, 1e9)[:, :, None, None]
        sf_flat = sf.reshape(P, -1)
        flat = torch.argmax(sf_flat, dim=1)
        gi, ri, ci = flat // (R * Cc), (flat % (R * Cc)) // Cc, flat % Cc
        best_raw = raw.reshape(P, -1).gather(1, flat[:, None])[:, 0]

        def subpeak(along):
            idx = [gi, ri, ci]
            n = (G, R, Cc)[along]
            i0 = torch.clamp(idx[along], 1, n - 2)

            def at(shift):
                sl = list(idx)
                sl[along] = torch.clamp(i0 + shift, 0, n - 1)
                f = (sl[0] * R + sl[1]) * Cc + sl[2]
                return sf_flat.gather(1, f[:, None])[:, 0]

            vm, v0, vp = at(-1), at(0), at(1)
            den = vm - 2.0 * v0 + vp
            d = torch.where(torch.abs(den) > 1e-9, 0.5 * (vm - vp) / den, 0.0)
            d = torch.clamp(d, -0.5, 0.5)
            ok = ((idx[along] >= 1) & (idx[along] <= n - 2) & (vm > -1e8)
                  & (vp > -1e8))
            return torch.where(ok, d, 0.0)

        sub_t = subpeak(0) * float(np.float32(dth_step))
        sub_r = subpeak(1) * res
        sub_c = subpeak(2) * res
        poses = torch.stack([
            anchors[:, 0] + (ci.to(torch.float32) - ca) * res + sub_c,
            anchors[:, 1] + (ri.to(torch.float32) - ra) * res + sub_r,
            C.wrap_angle(thetas[gi] + sub_t),
        ], dim=1)
        keep = (best_raw >= m["min_score"]) & in_range.gather(
            1, gi[:, None])[:, 0]
        return torch.where(keep[:, None], poses, priors), best_raw

    # -- the per-particle update ---------------------------------------------

    def update(self, maps, poses, ranges):
        """Every particle's update window integrated by the inverse sensor
        model, in place."""
        g, sen = self.grid, self.sensor
        P, H, W = maps.shape
        uwin = C.update_window_cells(g, sen)
        Hr, Wr = (uwin, uwin) if uwin < min(H, W) else (H, W)
        res = g["resolution"]
        ox0, oy0 = C.origin_xy(g)
        B = ranges.shape[0]
        dev = maps.device
        inv_res = C.inv_f32(res)
        cr = torch.floor((poses[:, 1] - oy0) * inv_res).to(torch.int64)
        cc = torch.floor((poses[:, 0] - ox0) * inv_res).to(torch.int64)
        r0 = torch.clamp(cr - Hr // 2, 0, H - Hr)
        c0 = torch.clamp(cc - Wr // 2, 0, W - Wr)
        ox = ox0 + c0.to(torch.float32) * res
        oy = oy0 + r0.to(torch.float32) * res
        pidx = torch.arange(P, device=dev)[:, None, None]
        rows = (r0[:, None] + torch.arange(Hr, device=dev))[:, :, None]
        cols = (c0[:, None] + torch.arange(Wr, device=dev))[:, None, :]
        old = maps[pidx, rows, cols]
        gw = old.to(torch.float32)

        min_r, max_r = sen["min_range"], sen["max_range"]
        r = torch.clamp(ranges, 0.0, max_r)
        valid = (ranges > min_r) & torch.isfinite(ranges)
        r_hit = torch.where(valid & (ranges < max_r), r, -1.0)
        rv = torch.where(valid, r, math.inf)
        rmin3 = torch.minimum(rv, torch.minimum(
            torch.cat([rv[:1], rv[:-1]]), torch.cat([rv[1:], rv[-1:]])))
        rmin3 = torch.where(valid & torch.isfinite(rmin3), rmin3, -1.0)

        col = torch.arange(Wr, dtype=torch.float32, device=dev)
        row = torch.arange(Hr, dtype=torch.float32, device=dev)
        px, py, pth = (poses[:, i, None, None] for i in range(3))
        cx = C.fma_f32((col + 0.5)[None, None, :], res, ox[:, None, None]) - px
        cy = C.fma_f32((row + 0.5)[None, :, None], res, oy[:, None, None]) - py
        d = torch.sqrt(cx * cx + cy * cy)
        phi = C.atan2_ref(cy.expand(P, Hr, Wr), cx.expand(P, Hr, Wr))
        phi = phi - pth - sen["angle_min"]
        phi = torch.remainder(phi + math.pi, 2 * math.pi) - math.pi
        step = C.beam_step(sen)
        k0 = torch.floor(phi / step)
        free = torch.zeros_like(d, dtype=torch.bool)
        for k in (k0, k0 + 1):
            kb = torch.clamp(k, 0, B - 1).to(torch.int64)
            free |= ((k >= 0) & (k <= B - 1)
                     & (torch.abs(phi - kb.to(torch.float32) * step)
                        <= 0.5 * step)
                     & (d < rmin3[kb] - res))
        occ_tol = float(np.float32(0.75 * res))
        tol = torch.full_like(d, occ_tol) / torch.clamp(d, min=1e-6)
        ab = torch.arange(B, dtype=torch.float32, device=dev) * step
        occ = torch.zeros_like(free)
        for b in range(B):
            occ |= ((torch.abs(phi - ab[b]) <= tol)
                    & (torch.abs(d - r_hit[b]) <= occ_tol))
        upd = (g["l_free"] * free.to(torch.float32)
               + g["l_occ"] * occ.to(torch.float32))
        out = torch.clamp(gw + upd * 1.0, -g["l_clamp"], g["l_clamp"])
        maps[pidx, rows, cols] = self._low(out).to(maps.dtype)
        return maps

    def _low(self, x):
        """`x` rounded through the control's precision (as it is without)."""
        if self.low is None:
            return x
        return x.to(self.low).to(x.dtype)


def _normalized(log_w):
    m = log_w.max()
    return log_w - (torch.log(torch.exp(log_w - m).sum()) + m)


def _softmax(log_w):
    e = torch.exp(log_w - log_w.max())
    return e / e.sum()


def effective_sample_size(log_w):
    w = _softmax(log_w)
    return 1.0 / (w * w).sum()


def systematic_ancestors(log_w, u):
    """Low-variance resampling: ancestor k is where (u + k) / P falls in
    the weights' CDF."""
    P = log_w.shape[0]
    cdf = torch.cumsum(_softmax(log_w), dim=0)
    k = torch.arange(P, dtype=torch.float32, device=log_w.device)
    pts = (u + k) * C.inv_f32(P)
    idx = torch.searchsorted(cdf, pts, right=False)
    return torch.clamp(idx, 0, P - 1).to(torch.int32)


def endpoint_splat(ranges, sensor, thetas, win, R, Cc, res, cdtype):
    """E [G, win, win]: the bilinear splat of each rotated scan's valid
    endpoints, the sensor at the window's centre cell, shifted by
    (-(R//2), -(C//2)); a beam whose patch leaves the window dropped."""
    pts_local, valid = C.scan_endpoints_local(ranges, sensor)
    pts = C.rotate_points(thetas, pts_local[None, :, :])
    inv_res = C.inv_f32(res)
    pos_col = torch.where(valid[None, :], pts[..., 0] * inv_res + win // 2,
                          0.0)
    pos_row = torch.where(valid[None, :], pts[..., 1] * inv_res + win // 2,
                          0.0)
    H = W = win
    ra, ca = R // 2, Cc // 2
    r0f, c0f = torch.floor(pos_row), torch.floor(pos_col)
    fr, fc = pos_row - r0f, pos_col - c0f
    r0 = r0f.to(torch.int64) - ra
    c0 = c0f.to(torch.int64) - ca
    ok = ((r0 >= 0) & (r0 <= H - (R + 1)) & (c0 >= 0) & (c0 <= W - (Cc + 1))
          & valid)
    r0 = torch.clamp(r0, 0, H - (R + 1))
    c0 = torch.clamp(c0, 0, W - (Cc + 1))
    lead = r0.shape[:-1]
    n = math.prod(lead)
    okf = ok.to(torch.float32)

    def rnd(w):
        return w.to(cdtype).to(torch.float32)

    wr = (rnd((1.0 - fr) * okf), rnd(fr * okf))
    wc = (rnd(1.0 - fc), rnd(fc))
    base = torch.arange(n, device=r0.device).reshape(*lead, 1) * (H * W)
    idx = torch.stack([base + (r0 + i) * W + (c0 + j)
                       for i in (0, 1) for j in (0, 1)], dim=-1)
    val = torch.stack([wr[i] * wc[j] for i in (0, 1) for j in (0, 1)],
                      dim=-1)
    E = torch.zeros(n * H * W, dtype=torch.float32, device=r0.device)
    E.index_put_((idx.reshape(-1),), val.reshape(-1), accumulate=True)
    return E.reshape(*lead, H, W).to(cdtype)


def shift_stack_plain(E, R: int, Cc: int):
    """[G, R*C, win, win]: E shifted by every (dr, dc), zero off the low
    edge."""
    G, win, _ = E.shape
    return torch.stack([F.pad(E, (dc, 0, dr, 0))[:, :win, :win]
                        for dr in range(R) for dc in range(Cc)], dim=1)


def window_field_plain(maps, origins, win, taps, inv_sat, free_logit,
                       free_penalty, out_dtype):
    """[P, win, win]: each particle's likelihood field over its window at
    an unclamped origin, cells off the map reading 0."""
    P, H, W = maps.shape
    dev = maps.device
    ar = torch.arange(win, device=dev)
    rows = origins[:, 0:1].to(torch.int64) + ar
    cols = origins[:, 1:2].to(torch.int64) + ar
    inside = (((rows >= 0) & (rows < H))[:, :, None]
              & ((cols >= 0) & (cols < W))[:, None, :])
    g = maps[torch.arange(P, device=dev)[:, None, None],
             torch.clamp(rows, 0, H - 1)[:, :, None],
             torch.clamp(cols, 0, W - 1)[:, None, :]]
    g = torch.where(inside, g, torch.zeros((), dtype=maps.dtype, device=dev))
    g = g.to(torch.float32)
    occ = torch.clamp(g * inv_sat, 0.0, 1.0)
    blur = torch.clamp(C.separable_blur(occ, taps), 0.0, 1.0)
    free = (g < free_logit).to(torch.float32)
    return (blur - free_penalty * free * (1.0 - blur)).to(out_dtype)
