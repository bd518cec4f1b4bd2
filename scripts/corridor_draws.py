#!/usr/bin/env python3
"""How far one run's accuracy on the corridor lap is a draw, for the JAX
package and the PyTorch port, on the CPU.

    python3 scripts/corridor_draws.py draws --package jax|port
        [--ulps=0,1,-1,...] [--update pallas_hybrid|sparse]
    python3 scripts/corridor_draws.py chunks [--update ...]
    python3 scripts/corridor_draws.py surfaces [--scans=296,328]
        [--out=surfaces.npz] [--update ...]

The config and log are chip_smoke.py phase 16's at the CLI's tile
defaults (bench_configs.fullslam_tiled_bench_config: 512^2 tiles at
0.05 m; fullslam_tiled_bench_log, 911 scans), the frontend alone: with no
loop attempt, full SLAM's trajectory there is the tiled frontend's. Both
packages run the map update `--update` names: the hybrid one (default;
the JAX kernel in interpret mode) or the sampled-ray one ("sparse", the
JAX package's CPU "auto"); the port runs on 2 CPU threads (its sums, so
its draws, depend on the thread count; so does the order of the
sampled-ray update's scatter-add).

- draws: run_tiled_frontend of one package once for each `--ulps` entry
  k, the sensor's first beam angle (so every beam's) moved by k float32
  ulps; prints each run's trajectory ATE (unaligned), one JSON line a run.
- chunks: the JAX package's run chunk by chunk; from JAX's state at the
  start of each chunk the port runs the same chunk (its plain versions),
  and the largest pose difference within the chunk is printed, one JSON
  line a chunk, with the scan where it occurs.
- surfaces: the JAX package's run, chunk by chunk up to the first scan of
  `--scans` and then scan by scan (each step jitted alone; the poses
  are held to the chunked run's); from JAX's state before each scan of
  the range both packages take that scan's match_scan (the port its
  plain versions) and, where JAX's step updates the map, the update and
  the search-space rebuild of the window. One JSON line a scan holds
  each stage's difference, port against JAX: the prior (the odometry
  compose), the beam endpoints (the cos/sin of the beam angles and of
  the candidate headings), each pass's endpoint positions and score
  array (each package's own chain, and the port's stage on JAX's
  inputs: "isolated"), the argmax of each pass (and the gap between
  JAX's best and the port's pick on JAX's surface), the sub-cell peak
  (theta, row, col offsets, beside the first-order bound that the fine
  scores' difference puts on it; the offsets come from this script's
  copies of match_scan's quadratic peak, `subpeak` and `_port_match`,
  applied to each package's fine scores, not from the packages' own
  sub-cell step, so a fault in that step shows only in the pose), the
  pose and the score; for an
  update, the window's log-odds cells that differ and the largest
  search-space difference, the port's rebuild taking JAX's updated
  window ("isolated"). A stage is judged on its isolated difference
  (the chain's is carried from the stages before it). The last line
  names the first judged stage, in the order above, whose difference
  passes what the float32 facts allow (ROADMAP queue 3's numeric
  facts: a few ulps from XLA's cos/sin and multiply-adds, the sums'
  order in a score), and its size. `--out` writes every array of both
  packages (but the search spaces) as one .npz.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _setup(ulps: int = 0, update: str = "pallas_hybrid"):
    """(JAX config, port config, JAX TileConfig, port TileConfig, log),
    the first beam angle moved by `ulps` float32 ulps and the map update
    `update` in both configs."""
    import jax
    import torch

    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(2)
    from scripts.relocalization_reference import _to_jax
    from slam2d_tpu.grid.tiles import TileConfig
    from slam2d_tpu_torch.run import bench_configs as bc

    cfg, tcfg, _ = bc.fullslam_tiled_bench_config()
    log = bc.fullslam_tiled_bench_log(cfg.sensor)
    a = np.float32(cfg.sensor.angle_min)
    for _ in range(abs(ulps)):
        a = np.nextafter(a, np.float32(np.sign(ulps) * np.inf))
    cfg = dataclasses.replace(
        cfg, grid=dataclasses.replace(cfg.grid, update_impl=update),
        sensor=dataclasses.replace(
            cfg.sensor, angle_min=float(a) if ulps else cfg.sensor.angle_min))
    return _to_jax(cfg), cfg, TileConfig(**dataclasses.asdict(tcfg)), tcfg, log


def draws(package: str, ulps: list[int], update: str):
    from slam2d_tpu_torch.metrics import ate_rmse

    for k in ulps:
        jcfg, cfg, jtcfg, tcfg, log = _setup(k, update)
        if package == "jax":
            from slam2d_tpu.run.frontend_tiled import run_tiled_frontend

            _, traj, _ = run_tiled_frontend(log, jcfg, jtcfg)
        else:
            from slam2d_tpu_torch.run.frontend_tiled import run_tiled_frontend

            _, traj, _ = run_tiled_frontend(log, cfg, tcfg, device="cpu")
        print(json.dumps(dict(
            package=package, angle_min_ulps=k, update_impl=update,
            traj_ate_m=ate_rmse(np.asarray(traj), log["gt_poses"],
                                align=False),
            ate_odom_m=ate_rmse(log["odom"], log["gt_poses"], align=False),
        )), flush=True)


def _jax_chunks(jcfg, jtcfg, log, stop=None):
    """The JAX package's run_tiled_frontend host loop, a chunk at a time:
    yields (first scan, the state at the chunk's start as numpy arrays,
    its odometry [K, 3] and ranges [K, B] (the tail padded), its length,
    JAX's poses [K, 3] and scores [K]); stops before the chunk at `stop`."""
    import jax
    import jax.numpy as jnp

    from slam2d_tpu.grid import tiles as jtiles
    from slam2d_tpu.grid.window import blur_halo_cells
    from slam2d_tpu.run import frontend_tiled as jft

    odom = np.asarray(log["odom"], np.float32)
    ranges = np.asarray(log["ranges"], np.float32)
    T, K = len(odom), jcfg.chunk
    state = jft.tiled_frontend_init(jtcfg, start_pose=odom[0],
                                    start_odom=odom[0])
    table = jtiles.TileTable(jtcfg)
    chunk_fn = jft.make_tiled_chunk_fn(jcfg, jtcfg)
    reach = (jcfg.sensor.max_range + jcfg.matcher.search_xy
             + blur_halo_cells(jcfg.matcher, jtcfg.resolution)
             * jtcfg.resolution + 2.0)
    est, base = odom[0], odom[0]
    for s in range(0, T if stop is None else min(T, stop), K):
        o, r = odom[s:s + K], ranges[s:s + K]
        n = len(o)
        if n < K:
            o = np.concatenate([o, np.repeat(o[-1:], K - n, axis=0)])
            r = np.concatenate([r, np.repeat(r[-1:], K - n, axis=0)])
        fx = [jft._np_compose(est, jft._np_between(base, o[t]))[:2]
              for t in range(K)]
        grid = table.activate(state.grid,
                              jtiles.required_tiles(np.asarray(fx), reach,
                                                    jtcfg))
        state = state._replace(
            grid=grid, sgrid=state.sgrid._replace(coords=grid.coords + 0))
        start = jax.tree.map(np.array, state)
        state, tr, sc = chunk_fn(state, jnp.asarray(o), jnp.asarray(r))
        tr, sc, est = (np.asarray(x) for x in jax.device_get(
            (tr, sc, state.pose)))
        base = o[-1]
        yield s, start, o, r, n, tr, sc


def chunks(update: str):
    import torch

    from slam2d_tpu_torch.run import frontend_tiled as tft

    jcfg, cfg, jtcfg, tcfg, log = _setup(update=update)
    K = cfg.chunk
    for s, start, o, r, n, tr, sc in _jax_chunks(jcfg, jtcfg, log):
        pst, _ = tft.tiled_state_from_numpy(list(start), tcfg, "cpu")
        out = torch.empty((K, 4))
        tft.run_tiled_chunk(pst, o, r, cfg, tcfg, out, plain=True)
        d = np.abs(out[:n, :3].numpy() - tr[:n])
        at = int(np.argmax(d.max(axis=1)))
        print(json.dumps(dict(
            first_scan=s, max_dxy_m=float(d[:, :2].max()),
            max_dtheta_rad=float(d[:, 2].max()), at_scan=s + at,
            max_dscore=float(np.abs(out[:n, 3].numpy() - sc[:n]).max()),
        )), flush=True)


F32_EPS = float(np.finfo(np.float32).eps)


def _ulps(a, b):
    """Largest |a - b| in float32 ulps of the larger magnitude."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = np.maximum(np.maximum(np.abs(a), np.abs(b)), 1e-30)
    return float((np.abs(a - b) / (np.spacing(scale.astype(np.float32))
                                   .astype(np.float64))).max())


def _jax_scan_fns(jcfg, jtcfg):
    """(step, match, update), jitted JAX functions of one scan: the tiled
    frontend step; match_scan from the state (spied: each pass's scores
    and penalized surface as match_scan computes them, the positions and
    the sub-cell peak in the same trace); the update and rebuild of the
    window at a pose."""
    import jax
    import jax.numpy as jnp

    from slam2d_tpu.core import se2
    from slam2d_tpu.grid.occupancy import (
        beam_angles, integrate_scan, scan_endpoints_local,
    )
    from slam2d_tpu.grid.tiles import gather_region, world_to_cell_global
    from slam2d_tpu.match import correlative as jc
    from slam2d_tpu.run import frontend_tiled as jft

    mcfg, sensor, res = jcfg.matcher, jcfg.sensor, jtcfg.resolution
    win = jft.tiled_window_cells(jtcfg, sensor, mcfg)
    gparam = jft._param_grid_cfg(jcfg, jtcfg)

    def origin_of(orc):
        return (jtcfg.origin_x + orc[1].astype(jnp.float32) * res,
                jtcfg.origin_y + orc[0].astype(jnp.float32) * res)

    step = jax.jit(lambda st, o, r: jft.tiled_frontend_step(
        st, o, r, jcfg, jtcfg))

    def subpeak(sf, idx):
        """match_scan's quadratic peak offsets (theta, row, col) in bins."""
        out = []
        for along in range(3):
            n, i = sf.shape[along], idx[along]
            i0 = jnp.clip(i, 1, n - 2)
            sm, s0, sp = list(idx), list(idx), list(idx)
            sm[along], s0[along], sp[along] = i0 - 1, i0, i0 + 1
            vm, v0, vp = sf[tuple(sm)], sf[tuple(s0)], sf[tuple(sp)]
            den = vm - 2.0 * v0 + vp
            d = jnp.where(jnp.abs(den) > 1e-9, 0.5 * (vm - vp) / den, 0.0)
            d = jnp.clip(d, -0.5, 0.5)
            out.append(jnp.where((i >= 1) & (i <= n - 2), d, 0.0))
        return jnp.stack(out)

    @jax.jit
    def match(state, odom, ranges):
        prior = se2.compose(state.pose, se2.between(state.prev_odom, odom))
        # the angles whose cos/sin the prior's compose takes
        prior_angles = jnp.stack([state.pose[2], state.prev_odom[2],
                                  se2.inverse(state.prev_odom)[2]])
        orc = world_to_cell_global(prior[:2], jtcfg) - win // 2
        Sw = gather_region(state.sgrid, jtcfg, orc, win)
        seen = []
        real_score, real_argmax = jc.score_offsets, jc._argmax3

        def score_spy(*a, **k):
            out = real_score(*a, **k)
            seen.append(dict(args=a, out=out))
            return out

        def argmax_spy(x):
            out = real_argmax(x)
            seen[-1].update(pen=x, idx=jnp.stack(out))
            return out

        jc.score_offsets, jc._argmax3 = score_spy, argmax_spy
        try:
            pose, best = jc.match_scan(
                None, ranges, prior, gparam, mcfg, sensor, search_space=Sw,
                origin_xy=origin_of(orc))
        finally:
            jc.score_offsets, jc._argmax3 = real_score, real_argmax
        pts, valid = scan_endpoints_local(ranges, sensor)
        angles = beam_angles(sensor)
        out = dict(prior=prior, orc=orc, Sw=Sw, pts=pts, valid=valid,
                   beam_cos=jnp.cos(angles), beam_sin=jnp.sin(angles),
                   prior_angles=prior_angles,
                   prior_cos=jnp.cos(prior_angles),
                   prior_sin=jnp.sin(prior_angles), pose=pose, best=best)
        for name, p in zip(("coarse", "fine")[-len(seen):], seen):
            S_, prior_, pts_, valid_, dth, _, _, cell, origin = p["args"]
            theta = prior_[2] + dth
            rot = se2.rotate_points(theta, pts_[None, :, :])
            pc = (rot[..., 0] + prior_[0] - origin[0]) / cell - 0.5
            pr = (rot[..., 1] + prior_[1] - origin[1]) / cell - 0.5
            out.update({
                f"{name}_S": S_, f"{name}_prior": prior_,
                f"{name}_dth": dth, f"{name}_origin": origin,
                f"{name}_cos": jnp.cos(theta), f"{name}_sin": jnp.sin(theta),
                f"{name}_pos_row": jnp.where(valid_[None], pr, 0.0),
                f"{name}_pos_col": jnp.where(valid_[None], pc, 0.0),
                f"{name}_scores": p["out"], f"{name}_pen": p["pen"],
                f"{name}_idx": p["idx"],
            })
        out["sub"] = subpeak(out["fine_pen"], out["fine_idx"])
        return out

    @jax.jit
    def update(state, pose, ranges):
        orc = world_to_cell_global(pose[:2], jtcfg) - win // 2
        gw = gather_region(state.grid, jtcfg, orc, win)
        gw2 = integrate_scan(gw, pose, ranges, gparam, sensor,
                             origin_xy=origin_of(orc))
        return dict(orc=orc, gw=gw, gw2=gw2,
                    S=jc.build_search_space(gw2, mcfg, res))

    return step, match, update


def _port_match(pst, odom, ranges, cfg, tcfg):
    """The port's match_scan (plain versions) of one scan from `pst`,
    spied as _jax_scan_fns's match: the same keys, as numpy arrays."""
    import torch

    from slam2d_tpu_torch.core import se2
    from slam2d_tpu_torch.grid.occupancy import (
        beam_angles, scan_endpoints_local,
    )
    from slam2d_tpu_torch.grid.tiles import (
        gather_region_t, world_to_cell_global,
    )
    from slam2d_tpu_torch.grid.window import window_origin_xy_t
    from slam2d_tpu_torch.match import correlative as tc
    from slam2d_tpu_torch.run import frontend_tiled as tft

    mcfg, sensor, res = cfg.matcher, cfg.sensor, tcfg.resolution
    win = tft.tiled_window_cells(tcfg, sensor, mcfg)
    gparam = tft._param_grid_cfg(cfg, tcfg)
    o = torch.as_tensor(odom)
    r = torch.as_tensor(ranges)
    prior = se2.compose(pst.pose, se2.between(pst.prev_odom, o))
    orc = world_to_cell_global(prior[:2], tcfg) - win // 2
    Sw = gather_region_t(pst.sgrid, tcfg, orc, win)
    seen = []
    real = (tc.score_offsets, tc._argmax3, tc.endpoint_positions)

    def score_spy(S_, prior_, pts_, valid_, dth, radius, cell, origin,
                  **k):
        seen.append(dict(S=S_, prior=prior_, dth=dth, origin=origin,
                         cos=torch.cos(prior_[2] + dth),
                         sin=torch.sin(prior_[2] + dth)))
        out = real[0](S_, prior_, pts_, valid_, dth, radius, cell, origin,
                      **k)
        seen[-1]["scores"] = out
        return out

    def argmax_spy(x):
        out = real[1](x)
        seen[-1].update(pen=x, idx=torch.stack(out))
        return out

    def pos_spy(*a):
        out = real[2](*a)
        seen[-1].update(pos_row=out[0], pos_col=out[1])
        return out

    tc.score_offsets, tc._argmax3, tc.endpoint_positions = (
        score_spy, argmax_spy, pos_spy)
    try:
        pose, best = tc.match_scan(
            None, r, prior, gparam, mcfg, sensor, search_space=Sw,
            origin_xy=window_origin_xy_t(tcfg.origin_x, tcfg.origin_y, res,
                                         orc),
            plain=True)
    finally:
        tc.score_offsets, tc._argmax3, tc.endpoint_positions = real
    pts, valid = scan_endpoints_local(r, sensor)
    angles = beam_angles(sensor, "cpu")
    out = dict(prior=prior, orc=orc, Sw=Sw, pts=pts, valid=valid,
               beam_cos=torch.cos(angles), beam_sin=torch.sin(angles),
               pose=pose, best=best)
    for name, p in zip(("coarse", "fine")[-len(seen):], seen):
        out.update({f"{name}_{k}": v for k, v in p.items()})
    sf, idx = out["fine_pen"], out["fine_idx"]
    sub = []
    for along in range(3):
        n, i = sf.shape[along], idx[along]
        i0 = torch.clamp(i, 1, n - 2)
        sm, s0, sp = list(idx), list(idx), list(idx)
        sm[along], s0[along], sp[along] = i0 - 1, i0, i0 + 1
        vm, v0, vp = sf[tuple(sm)], sf[tuple(s0)], sf[tuple(sp)]
        den = vm - 2.0 * v0 + vp
        d = torch.where(torch.abs(den) > 1e-9, 0.5 * (vm - vp) / den, 0.0)
        d = torch.clamp(d, -0.5, 0.5)
        sub.append(torch.where((i >= 1) & (i <= n - 2), d, 0.0))
    out["sub"] = torch.stack(sub)
    return {k: (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
            for k, v in out.items()}


def _peak_sensitivity(sf, idx, dscore):
    """The most each sub-cell offset (bins) can move when every value of
    the penalized surface `sf` moves by at most `dscore`: the first-order
    change of 0.5 (vm - vp) / (vm - 2 v0 + vp), clipped to 1 bin."""
    out = []
    for along in range(3):
        n, i = sf.shape[along], int(idx[along])
        if not 1 <= i <= n - 2:
            out.append(0.0)
            continue
        at = [int(x) for x in idx]
        vm, v0, vp = (float(sf[tuple(at[:along] + [j] + at[along + 1:])])
                      for j in (i - 1, i, i + 1))
        den = vm - 2.0 * v0 + vp
        if abs(den) <= 1e-9:
            out.append(1.0)
            continue
        grad = (abs(0.5 / den) * 2 + abs(0.5 * (vm - vp) / den ** 2) * 4)
        out.append(min(1.0, grad * dscore))
    return np.asarray(out)


def surfaces(first: int, last: int, update: str, out_path: str | None):
    """See the module doc (surfaces)."""
    import jax
    import jax.numpy as jnp
    import torch

    from slam2d_tpu_torch.grid.occupancy import integrate_scan_window
    from slam2d_tpu_torch.grid.window import blur_halo_cells
    from slam2d_tpu_torch.match.correlative import (
        endpoint_positions, gaussian_kernel_1d,
    )
    from slam2d_tpu_torch.ops.score import score_window_plain
    from slam2d_tpu_torch.ops.search_space import search_space_plain
    from slam2d_tpu_torch.run import frontend_tiled as tft

    jcfg, cfg, jtcfg, tcfg, log = _setup(update=update)
    mcfg, res, K = cfg.matcher, tcfg.resolution, cfg.chunk
    f = mcfg.coarse_factor
    halo = blur_halo_cells(mcfg, res)
    taps = gaussian_kernel_1d(mcfg.sigma_m / res, halo)
    gparam = tft._param_grid_cfg(cfg, tcfg)
    B = cfg.sensor.n_beams
    # what float32 allows (ROADMAP queue 3's numeric facts): XLA's CPU
    # cos/sin within 2 ulps; an endpoint position (cells) within 4 ulps
    # of its world coordinate (x + prior - origin cancels: the result's
    # own ulps would overstate it); a mean of B beams within B half-ulps
    # of 1 (the sums' order); the blur's 2 x 13 taps within 2 x 13
    # half-ulps; 0.05% of an update's cells
    allow = dict(cos_sin_ulps=2.0, pos_ulps=4.0,
                 score=B * F32_EPS / 2, blur=2 * len(taps) * F32_EPS / 2,
                 update_cells=5e-4)
    step, jmatch, jupdate = _jax_scan_fns(jcfg, jtcfg)
    odom = np.asarray(log["odom"], np.float32)
    ranges = np.asarray(log["ranges"], np.float32)
    keep = {}
    first_departure = None
    c0 = first // K * K
    for s, start, o, r, n, tr, sc in _jax_chunks(jcfg, jtcfg, log,
                                                 stop=last + 1):
        if s < c0:
            continue
        state = jax.tree.map(jnp.asarray, start)
        for t in range(s, min(s + n, last + 1)):
            before = jax.tree.map(np.array, state)
            state, (jpose, jscore) = step(state, jnp.asarray(odom[t]),
                                          jnp.asarray(ranges[t]))
            if t < first:
                continue
            jpose = np.asarray(jpose)
            matched = float(jscore) != -1.0
            did_update = not np.array_equal(
                np.asarray(state.last_map_pose), before.last_map_pose)
            jm = {k: np.array(v) for k, v in jmatch(
                jax.tree.map(jnp.asarray, before), jnp.asarray(odom[t]),
                jnp.asarray(ranges[t])).items()}
            pst, _ = tft.tiled_state_from_numpy(list(before), tcfg, "cpu")
            pm = _port_match(pst, odom[t], ranges[t], cfg, tcfg)
            row = dict(scan=t, matched=matched,
                       stepped_vs_chunked_dpose=float(
                           np.abs(jpose - tr[t - s]).max()))
            if matched:
                row["match_vs_step_dpose"] = float(
                    np.abs(jm["pose"] - jpose).max())
            stages = []

            def stage(name, size, allowed, judged=True, **extra):
                """A stage's difference; `judged=False`: carried from an
                earlier stage (each package's own chain), shown only."""
                row[name] = dict(size=size, allowed=allowed, **extra)
                if judged:
                    stages.append((name, size, allowed))

            # the prior's compose: XLA's cos/sin and its contraction of
            # the multiply-adds into FMAs, which the port does not
            # reproduce (ROADMAP queue 3's numeric facts); `cos_sin_apart`
            # says whether a cos or sin of its angles differs, so a
            # difference without one is the contraction's
            th = torch.as_tensor(jm["prior_angles"])
            cs_apart = not (np.array_equal(torch.cos(th).numpy(),
                                           jm["prior_cos"])
                            and np.array_equal(torch.sin(th).numpy(),
                                               jm["prior_sin"]))
            stage("prior_ulps", _ulps(pm["prior"], jm["prior"]),
                  allow["cos_sin_ulps"] + 1,
                  m=float(np.abs(pm["prior"] - jm["prior"]).max()),
                  cos_sin_apart=cs_apart)
            stage("window_origin", int(np.abs(pm["orc"] - jm["orc"]).max()),
                  0)
            stage("search_window", float(np.abs(pm["Sw"] - jm["Sw"]).max()),
                  0.0)
            stage("beam_cos_sin_ulps", max(
                _ulps(pm["beam_cos"], jm["beam_cos"]),
                _ulps(pm["beam_sin"], jm["beam_sin"])),
                allow["cos_sin_ulps"],
                beams_differing=int(((pm["beam_cos"] != jm["beam_cos"])
                                     | (pm["beam_sin"] != jm["beam_sin"]))
                                    .sum()))
            stage("endpoints_ulps", _ulps(pm["pts"], jm["pts"]),
                  allow["cos_sin_ulps"] + 1)
            for name in ("coarse", "fine"):
                if f"{name}_scores" not in jm:
                    continue
                J = {k[len(name) + 1:]: v for k, v in jm.items()
                     if k.startswith(name + "_")}
                P = {k[len(name) + 1:]: v for k, v in pm.items()
                     if k.startswith(name + "_")}
                stage(f"{name}_heading_cos_sin_ulps", max(
                    _ulps(P["cos"], J["cos"]), _ulps(P["sin"], J["sin"])),
                    allow["cos_sin_ulps"])
                cell = res * (f if name == "coarse" else 1)
                # a world ulp at the endpoints' reach, in cells
                wulp = float(np.spacing(np.float32(
                    np.abs(J["prior"][:2]).max()
                    + cfg.sensor.max_range))) / cell

                def pos_ulps(pr, pc):
                    return float(max(np.abs(pr - J["pos_row"]).max(),
                                     np.abs(pc - J["pos_col"]).max())
                                 / wulp)

                stage(f"{name}_positions_ulps",
                      pos_ulps(P["pos_row"], P["pos_col"]),
                      allow["pos_ulps"], judged=False)
                # the port's positions from JAX's prior, endpoints, thetas
                ipr, ipc = (x.numpy() for x in endpoint_positions(
                    torch.as_tensor(J["prior"]), torch.as_tensor(jm["pts"]),
                    torch.as_tensor(jm["valid"]), torch.as_tensor(J["dth"]),
                    cell, torch.as_tensor(J["origin"])))
                stage(f"{name}_positions_isolated_ulps", pos_ulps(ipr, ipc),
                      allow["pos_ulps"])
                # the port's scorer on JAX's search space and positions
                radius = (J["scores"].shape[1] - 1) // 2
                iso = score_window_plain(
                    torch.as_tensor(J["S"]), torch.as_tensor(J["pos_row"]),
                    torch.as_tensor(J["pos_col"]),
                    torch.as_tensor(jm["valid"]), radius,
                    name == "fine").numpy()
                stage(f"{name}_scores_isolated",
                      float(np.abs(iso - J["scores"]).max()), allow["score"])
                dsc = float(np.abs(P["scores"] - J["scores"]).max())
                same = bool(np.array_equal(P["idx"], J["idx"]))
                gap = float(J["pen"][tuple(J["idx"])]
                            - J["pen"][tuple(P["idx"])])
                stage(f"{name}_scores", dsc, allow["score"], judged=False)
                stage(f"{name}_argmax", 0.0 if same else gap, 2 * dsc,
                      jax=J["idx"].tolist(), port=P["idx"].tolist())
            dsc = float(np.abs(pm["fine_pen"] - jm["fine_pen"]).max())
            sens = _peak_sensitivity(jm["fine_pen"], jm["fine_idx"], dsc)
            dsub = np.abs(pm["sub"] - jm["sub"])
            j_ok = np.array_equal(pm["fine_idx"], jm["fine_idx"])
            stage("subpeak_bins", float(dsub.max()),
                  float(sens.max()) if j_ok else 1.0,
                  jax=jm["sub"].tolist(), port=pm["sub"].tolist(),
                  per_axis_bound=sens.tolist())
            row["pose_dxy_m"] = float(np.abs(pm["pose"][:2]
                                             - jm["pose"][:2]).max())
            row["pose_dtheta_rad"] = float(abs(pm["pose"][2]
                                               - jm["pose"][2]))
            row["score_diff"] = float(pm["best"] - jm["best"])
            if did_update:
                ju = {k: np.array(v) for k, v in jupdate(
                    jax.tree.map(jnp.asarray, before), jnp.asarray(jpose),
                    jnp.asarray(ranges[t])).items()}
                gw = torch.as_tensor(ju["gw"]).clone()
                orc = torch.as_tensor(ju["orc"])
                integrate_scan_window(
                    gw, torch.as_tensor(jpose), torch.as_tensor(ranges[t]),
                    gparam, cfg.sensor, origin=None, cell=orc,
                    size=tuple(gw.shape), gate=torch.tensor(True),
                    origin_xy=(tcfg.origin_x, tcfg.origin_y), plain=True)
                off = (gw.numpy() != ju["gw2"])
                stage("update_cells_share", float(off.mean()),
                      allow["update_cells"], cells=int(off.sum()),
                      max_abs=float(np.abs(gw.numpy() - ju["gw2"]).max()))
                Sp = search_space_plain(
                    torch.as_tensor(ju["gw2"]), taps, mcfg.occ_evidence_sat,
                    mcfg.free_threshold, mcfg.free_penalty).numpy()
                h = slice(halo, -halo)
                stage("rebuild_isolated",
                      float(np.abs(Sp[h, h] - ju["S"][h, h]).max()),
                      allow["blur"])
            row["updated"] = did_update
            if not matched:   # the step kept its prior: no match ran
                stages = [x for x in stages if not x[0].startswith(
                    ("coarse", "fine", "subpeak"))]
            for name, size, allowed in stages:
                if size > allowed and first_departure is None:
                    first_departure = dict(scan=t, stage=name, size=size,
                                           allowed=allowed)
            print(json.dumps(row), flush=True)
            if out_path:
                keep.update({f"{t}/jax/{k}": v for k, v in jm.items()
                             if k not in ("Sw", "coarse_S", "fine_S")})
                keep.update({f"{t}/port/{k}": v for k, v in pm.items()
                             if k not in ("Sw", "coarse_S", "fine_S")})
    print(json.dumps(dict(scans=[first, last], update_impl=update,
                          allowed=allow, first_departure=first_departure)))
    if out_path:
        np.savez_compressed(out_path, **keep)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", choices=("draws", "chunks", "surfaces"))
    ap.add_argument("--package", choices=("jax", "port"), default="port")
    ap.add_argument("--ulps", default="0,1,-1,2,-2,3,-3,4,-4,5,-5,6,-6")
    ap.add_argument("--update", choices=("pallas_hybrid", "sparse"),
                    default="pallas_hybrid")
    ap.add_argument("--scans", default="296,328",
                    help="surfaces: the first and last scan")
    ap.add_argument("--out", default=None,
                    help="surfaces: write every array to this .npz")
    args = ap.parse_args()
    if args.mode == "draws":
        draws(args.package, [int(k) for k in args.ulps.split(",")],
              args.update)
    elif args.mode == "chunks":
        chunks(args.update)
    else:
        first, last = (int(k) for k in args.scans.split(","))
        surfaces(first, last, args.update, args.out)


if __name__ == "__main__":
    main()
