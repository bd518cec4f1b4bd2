#!/usr/bin/env python3
"""Drive the PyTorch port (slam2d_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

from the repository root. It needs a CUDA card, PyTorch built for CUDA and
nvcc; it imports nothing of JAX. Phases, each of which raises on failure:

1. the card: its name and power limit (nvidia-smi);
2. the build of every kernel in slam2d_tpu_torch/csrc/ (nvcc, sm_90a, one
   nvcc per source, all started together);
3. each kernel against its plain PyTorch version on the card, at its main
   path's shapes (the frontend's and FastSLAM-100's), with inputs made
   from a seed; both timed with CUDA events (median of 30 launches after
   warmup);
4. the frontend at bench.py's config and log (1024^2 grid at 0.05 m, 180
   beams, 1078 scans, chunk 64): finite trajectory, ATE below odometry,
   every kernel launched (updates, search-space builds and scorer passes
   counted against the gate decisions); scans/s, ATE, launch counts and
   host syncs;
5. the first 256 scans again with every kernel replaced by its plain
   version on the card: the poses must agree within 5e-3 m / 5e-3 rad;
6. FastSLAM at bench_pf.py's default config and log (100 particles, bf16
   512^2 maps at 0.1 m, 653 scans): finite trajectory and N_eff, ATE at
   most 1 m, at least one resample, every PF kernel launched as often as
   the gates decided (ISM update once per update event, field and stack
   once per refine event, row gather once per resample); scans/s, ATE
   against odometry's, host reads per scan;
7. the first 8 refine events of that run, each from the same state with
   the same draws through the kernels and through their plain versions:
   poses, log-weights and maps must agree within the stated tolerances.

Prints one JSON line with the kernels' numbers, then as its last line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import statistics
import sys
import time

import numpy as np
import torch

from slam2d_tpu.metrics import ate_rmse
from slam2d_tpu_torch.grid import occupancy
from slam2d_tpu_torch.grid.window import (
    blur_halo_cells,
    extract_window,
    scan_window_cells,
    update_window_cells,
)
from slam2d_tpu_torch.match import correlative
from slam2d_tpu_torch.ops import _build
from slam2d_tpu_torch.ops.field import window_field
from slam2d_tpu_torch.ops.gather import gather_rows
from slam2d_tpu_torch.ops.score import score_window
from slam2d_tpu_torch.ops.search_space import search_space
from slam2d_tpu_torch.ops.stack import shift_stack
from slam2d_tpu_torch.ops.update import update_hybrid, update_ism
from slam2d_tpu_torch.pf import fastslam
from slam2d_tpu_torch.pf.shared_refine import endpoint_splat
from slam2d_tpu_torch.run.bench_configs import (
    bench_config,
    bench_log,
    card,
    pf_bench_config,
    pf_bench_log,
)
from slam2d_tpu_torch.run.fastslam_run import run_fastslam
from slam2d_tpu_torch.run.frontend import frontend_step, run_frontend

SEED = 0
KERNEL_TIMING_RUNS = 30
PARITY_SCANS = 256
POSE_TOL_M = 5e-3
POSE_TOL_RAD = 5e-3
PF_MAX_ATE_M = 1.0        # phase 6: above this the filter diverged
PF_PARITY_REFINES = 8     # phase 7
PF_POSE_TOL = 2e-4        # phase 7, m and rad
PF_LOGW_TOL = 3e-3        # phase 7: 30 x score 5e-5 on two particles
MAP_CELL_SHARE = 0.0005   # cells an update may flip (one l_free / l_occ)
BF16_STEP_ATOL = 0.07     # a flipped bf16 cell: the step +- one bf16 ulp


def _cuda_ms(fn, runs: int = KERNEL_TIMING_RUNS, warmup: int = 3) -> float:
    """Median milliseconds of one call of `fn`, timed with CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def kernel_checks(cfg, log, device):
    """Phase 3: each kernel against its plain version at main-path shapes."""
    rng = np.random.default_rng(SEED)
    g, m, s = cfg.grid, cfg.matcher, cfg.sensor
    uwin = update_window_cells(g, s, m)
    win = scan_window_cells(g, s, m)
    i = len(log["odom"]) // 2
    pose_np = np.asarray(log["gt_poses"][i], np.float32)
    pose = torch.as_tensor(pose_np, device=device)
    ranges = torch.as_tensor(log["ranges"][i], device=device)
    full = torch.as_tensor(
        rng.uniform(-6.0, 6.0, (g.height, g.width)).astype(np.float32),
        device=device,
    )
    center = occupancy.world_to_cell(pose[:2], g).tolist()
    results = {}

    # kernel 1: hybrid update of the 520^2 update window
    gw, origin_rc = extract_window(full, center, uwin)

    def update(plain):
        return occupancy.integrate_scan(
            gw, pose, ranges, g, s, origin_rc=origin_rc, plain=plain
        )

    a, b = update(False), update(True)
    diff = (a - b).abs()
    n_diff = int((diff != 0).sum())
    off = diff[diff != 0]
    one_step = ((off - abs(g.l_free)).abs() < 1e-5) | (
        (off - g.l_occ).abs() < 1e-5
    )
    print(f"update_hybrid [{uwin}x{uwin}]: {n_diff} of {gw.numel()} cells "
          "differ (tolerance: <= 0.05%, each by one l_free or l_occ)")
    if n_diff > 0.0005 * gw.numel() or not bool(one_step.all()):
        raise AssertionError("update_hybrid disagrees with its plain version")
    results["update_hybrid"] = dict(
        max_abs_err=float(diff.max()), cells_differing=n_diff,
        tolerance="<=0.05% of cells, each by one l_free or l_occ",
        ms=_cuda_ms(lambda: update(False)),
        plain_ms=_cuda_ms(lambda: update(True)),
        shape=[uwin, uwin],
    )

    # kernel 3: search-space build of the update window and of the full map
    def field(x, plain):
        return correlative.build_search_space(x, m, g.resolution, plain=plain)

    errs = {}
    for name, x in (("window", gw), ("full", full)):
        errs[name] = float((field(x, False) - field(x, True)).abs().max())
        print(f"search_space [{x.shape[0]}x{x.shape[1]}]: max |err| "
              f"{errs[name]:.3g} (tolerance 1e-6)")
    if max(errs.values()) > 1e-6:
        raise AssertionError("search_space disagrees with its plain version")
    results["search_space"] = dict(
        max_abs_err=max(errs.values()), tolerance="atol 1e-6",
        ms=_cuda_ms(lambda: field(gw, False)),
        plain_ms=_cuda_ms(lambda: field(gw, True)), shape=[uwin, uwin],
        full_map_ms=_cuda_ms(lambda: field(full, False)),
        full_map_plain_ms=_cuda_ms(lambda: field(full, True)),
    )

    # kernel 2: coarse [13, 5, 5] on the 136^2 pooled window, fine
    # [5, 9, 9] bilinear on the 544^2 scan window
    S = field(full, False)
    Sw, org = extract_window(S, center, win)
    origin = occupancy.window_origin_xy(g, org)
    Sc = correlative.coarse_space(Sw, m.coarse_factor)
    pts, valid = occupancy.scan_endpoints_local(ranges, s)
    prior = pose + torch.as_tensor(
        rng.uniform(-0.1, 0.1, 3).astype(np.float32), device=device
    )
    dth = torch.as_tensor(correlative._theta_offsets(m), device=device)
    r_fine = int(round(m.search_xy / g.resolution))
    r_coarse = -(-r_fine // m.coarse_factor)
    pos_c = correlative.endpoint_positions(
        prior, pts, valid, dth, g.resolution * m.coarse_factor, origin)
    pos_f = correlative.endpoint_positions(
        prior, pts, valid, dth[4:9], g.resolution, origin)
    passes = {
        "coarse": lambda plain: score_window(
            Sc, *pos_c, valid, r_coarse, False, plain=plain),
        "fine": lambda plain: score_window(
            Sw, *pos_f, valid, m.coarse_factor, True, plain=plain),
    }
    errs, times = {}, {}
    for name, fn in passes.items():
        out = fn(False)
        errs[name] = float((out - fn(True)).abs().max())
        times[name] = (_cuda_ms(lambda: fn(False)), _cuda_ms(lambda: fn(True)))
        print(f"score_offsets {name} {list(out.shape)}: max |err| "
              f"{errs[name]:.3g} (tolerance 1e-5)")
    if max(errs.values()) > 1e-5:
        raise AssertionError("score_offsets disagrees with its plain version")
    results["score_offsets"] = dict(
        max_abs_err=max(errs.values()), tolerance="atol 1e-5",
        ms=times["fine"][0], plain_ms=times["fine"][1], shape=[5, 9, 9],
        coarse_ms=times["coarse"][0], coarse_plain_ms=times["coarse"][1],
    )
    return results


def _counters():
    return {
        "update_hybrid": update_hybrid,
        "score_offsets": score_window,
        "search_space": search_space,
    }


def run_slice(cfg, log, device):
    """Phase 4: the frontend over the whole bench log through the kernels."""
    warm = {k: np.asarray(v)[: cfg.chunk] for k, v in log.items()}
    run_frontend(warm, cfg, device)
    torch.cuda.synchronize()

    for fn in _counters().values():
        fn.launches = 0
    for name in ("host_syncs", "matches", "updates"):
        setattr(frontend_step, name, 0)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    _, traj, scores = run_frontend(log, cfg, device)
    end.record()
    end.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in _counters().items()}
    T = len(traj)
    counts = dict(
        host_syncs=frontend_step.host_syncs, matches=frontend_step.matches,
        updates=frontend_step.updates,
    )

    if not np.isfinite(traj).all():
        raise AssertionError("trajectory is not finite")
    ate = ate_rmse(traj, log["gt_poses"], align=False)
    ate_odom = ate_rmse(log["odom"], log["gt_poses"], align=False)
    if not ate < ate_odom:
        raise AssertionError(f"ATE {ate} is not below odometry's {ate_odom}")
    # skipped scans report exactly -1; a matched score is >= -free_penalty
    matched_in_log = int((scores != -1.0).sum())
    expect = {
        "update_hybrid": counts["updates"],
        "search_space": counts["updates"] + 1,
        "score_offsets": 2 * counts["matches"],
    }
    if launches != expect or min(launches.values()) <= 0:
        raise AssertionError(f"launches {launches}, expected {expect}")
    if matched_in_log > counts["matches"]:
        raise AssertionError("more matched scores than matches counted")
    elapsed = start.elapsed_time(end) / 1e3
    result = dict(
        scans=T, scans_run=-(-T // cfg.chunk) * cfg.chunk,
        scans_per_sec=T / elapsed, seconds_cuda_events=elapsed,
        seconds_host=wall, ate_m=ate, ate_odom_m=ate_odom,
        launches=launches, **counts,
    )
    print("slice:", json.dumps(result))
    return traj, launches


def parity_run(cfg, log, device, traj):
    """Phase 5: the first scans with every kernel's plain version."""
    part = {k: np.asarray(v)[:PARITY_SCANS] for k, v in log.items()}
    _, traj_plain, _ = run_frontend(part, cfg, device, plain=True)
    ref = traj[:PARITY_SCANS]
    dxy = float(np.max(np.hypot(*(ref[:, :2] - traj_plain[:, :2]).T)))
    dth = float(np.max(np.abs(
        np.angle(np.exp(1j * (ref[:, 2] - traj_plain[:, 2])))
    )))
    print(f"plain-version slice, {PARITY_SCANS} scans: max |dxy| {dxy:.3g} m, "
          f"max |dtheta| {dth:.3g} rad (tolerance {POSE_TOL_M} / {POSE_TOL_RAD})")
    if dxy > POSE_TOL_M or dth > POSE_TOL_RAD:
        raise AssertionError("kernel and plain slices disagree")


def _map_cells_ok(a, b, gcfg, name):
    """Maps that an update produced twice: at most MAP_CELL_SHARE of the
    cells differ, each by one l_free or l_occ (in the map's dtype).
    Returns (cells differing, max |err|)."""
    diff = (a.float() - b.float()).abs()
    off = diff[diff != 0]
    one_step = ((off - abs(gcfg.l_free)).abs() <= BF16_STEP_ATOL) | (
        (off - gcfg.l_occ).abs() <= BF16_STEP_ATOL
    )
    if off.numel() > MAP_CELL_SHARE * diff.numel() or not bool(one_step.all()):
        raise AssertionError(
            f"{name}: {off.numel()} of {diff.numel()} cells differ "
            f"(max {float(diff.max())})"
        )
    return off.numel(), float(diff.max())


def pf_kernel_checks(cfg, pf, log, device):
    """Phase 3 for the particle filter's kernels, at FastSLAM-100 shapes."""
    rng = np.random.default_rng(SEED + 1)
    g, s = cfg.grid, cfg.sensor
    P, res = pf.n_particles, g.resolution
    mdt = getattr(torch, pf.map_dtype)
    maps = torch.as_tensor(
        rng.uniform(-6.0, 6.0, (P, g.height, g.width)).astype(np.float32),
        device=device,
    ).to(mdt)
    ranges = torch.as_tensor(log["ranges"][len(log["odom"]) // 2], device=device)
    results = {}

    # kernel 1, variant ism: every particle's 256^2 update window, with
    # poses all over the map so that windows clamp at every edge
    uwin = update_window_cells(g, s)
    xy = rng.uniform(0.0, g.width * res, (P, 2)) + (g.origin_x, g.origin_y)
    poses = torch.as_tensor(
        np.column_stack([xy, rng.uniform(-np.pi, np.pi, P)]).astype(np.float32),
        device=device,
    )

    def ism(m, plain):
        return update_ism(
            m, poses, ranges, region=(uwin, uwin),
            origin_xy=(g.origin_x, g.origin_y), plain=plain,
            **occupancy.update_constants(g, s),
        )

    n_diff, err = _map_cells_ok(
        ism(maps.clone(), False), ism(maps.clone(), True), g, "update_ism"
    )
    print(f"update_ism [{P}, {uwin}x{uwin}] of {pf.map_dtype} "
          f"[{g.height}x{g.width}] maps: {n_diff} cells differ (tolerance: "
          f"<= {MAP_CELL_SHARE:.2%} of {P * uwin * uwin}, each by one l_free "
          "or l_occ)")
    scratch = maps.clone()
    results["update_ism"] = dict(
        max_abs_err=err, cells_differing=n_diff,
        tolerance="<=0.05% of window cells, each by one l_free or l_occ",
        ms=_cuda_ms(lambda: ism(scratch, False)),
        plain_ms=_cuda_ms(lambda: ism(scratch, True)),
        shape=[P, uwin, uwin],
    )

    # kernel 4: the resample's row gather, with repeated ancestors
    flat = maps.reshape(P, -1)
    anc = torch.as_tensor(
        np.sort(rng.integers(0, P, P)).astype(np.int32), device=device
    )
    if len(set(anc.tolist())) == P:
        raise AssertionError("the gather check needs repeated ancestors")
    same = torch.equal(gather_rows(flat, anc), gather_rows(flat, anc, plain=True))
    print(f"gather_rows {list(flat.shape)} {pf.map_dtype}: bit-exact {same}")
    if not same:
        raise AssertionError("gather_rows disagrees with its plain version")
    results["gather_rows"] = dict(
        max_abs_err=0.0, tolerance="bit-exact",
        ms=_cuda_ms(lambda: gather_rows(flat, anc)),
        plain_ms=_cuda_ms(lambda: gather_rows(flat, anc, plain=True)),
        shape=list(flat.shape),
    )

    # kernel 6: every particle's field over its unclamped 288^2 window,
    # origins off every edge of the map
    mcfg = fastslam.refine_matcher(cfg, pf)
    win = scan_window_cells(g, s, mcfg)
    cdtype = torch.bfloat16 if mcfg.score_bf16 else torch.float32
    org = rng.integers(-win // 2 - 60, g.height - win // 2 + 60, (P, 2))
    org[:6] = [[-100, 10], [10, -100], [g.height - 100, 10],
               [10, g.width - 100], [-win - 5, 40], [g.height + 3, -3]]
    origins = torch.as_tensor(org.astype(np.int32), device=device)
    taps = correlative.gaussian_kernel_1d(
        mcfg.sigma_m / res, blur_halo_cells(mcfg, res)
    )
    thr = mcfg.free_threshold
    fkw = dict(
        inv_sat=1.0 / mcfg.occ_evidence_sat,
        free_logit=float(np.log(thr / (1.0 - thr))),
        free_penalty=mcfg.free_penalty, out_dtype=cdtype,
    )

    def field(plain):
        return window_field(maps, origins, win, taps, plain=plain, **fkw)

    a, b = field(False).float(), field(True).float()
    diff = (a - b).abs()
    n_diff = int((diff != 0).sum())
    one_ulp = bool(((diff == 0) | (diff <= 2.0 ** -7 * b.abs())).all())
    print(f"window_field [{P}, {win}x{win}] {cdtype}: {n_diff} cells differ, "
          f"max |err| {float(diff.max()):.3g} (tolerance: <= 0.01% of cells, "
          "each by one bf16 ulp)")
    if n_diff > 1e-4 * diff.numel() or not one_ulp:
        raise AssertionError("window_field disagrees with its plain version")
    results["window_field"] = dict(
        max_abs_err=float(diff.max()), cells_differing=n_diff,
        tolerance="<=0.01% of cells, each by one ulp of the out dtype",
        ms=_cuda_ms(lambda: field(False)),
        plain_ms=_cuda_ms(lambda: field(True)), shape=[P, win, win],
    )

    # kernel 7: the shift stack of the scan's endpoint splats
    G = mcfg.n_theta + 2 * pf.refine_theta_pad
    R = 2 * int(round(mcfg.search_xy / res)) + 1
    thetas = torch.linspace(-0.2, 0.2, G, device=device)
    E = endpoint_splat(ranges, s, thetas, win, R, R, res, cdtype)
    same = torch.equal(shift_stack(E, R, R), shift_stack(E, R, R, plain=True))
    print(f"shift_stack {list(E.shape)} -> [{G}, {R * R}, {win}, {win}] "
          f"{cdtype}: bit-exact {same}")
    if not same:
        raise AssertionError("shift_stack disagrees with its plain version")
    results["shift_stack"] = dict(
        max_abs_err=0.0, tolerance="bit-exact",
        ms=_cuda_ms(lambda: shift_stack(E, R, R)),
        plain_ms=_cuda_ms(lambda: shift_stack(E, R, R, plain=True)),
        shape=[G, R * R, win, win],
    )
    return results


def _pf_counters():
    return {
        "update_ism": update_ism,
        "window_field": window_field,
        "shift_stack": shift_stack,
        "gather_rows": gather_rows,
    }


def _reset_pf_counts():
    for fn in _pf_counters().values():
        fn.launches = 0
    for name in ("host_syncs", "refines", "updates", "resamples"):
        setattr(fastslam.fastslam_step, name, 0)


def run_pf(cfg, pf, log, device):
    """Phase 6: FastSLAM over the whole bench_pf log through the kernels."""
    warm = {k: np.asarray(v)[:64] for k, v in log.items()}
    run_fastslam(warm, cfg, pf, device, seed=SEED)
    torch.cuda.synchronize()

    _reset_pf_counts()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    _, traj, n_eff, _ = run_fastslam(log, cfg, pf, device, seed=SEED)
    end.record()
    end.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in _pf_counters().items()}
    step = fastslam.fastslam_step
    counts = dict(
        host_syncs=step.host_syncs, refines=step.refines,
        updates=step.updates, resamples=step.resamples,
    )
    T = len(traj)

    if not (np.isfinite(traj).all() and np.isfinite(n_eff).all()):
        raise AssertionError("trajectory or N_eff is not finite")
    ate = ate_rmse(traj, log["gt_poses"], align=False)
    ate_odom = ate_rmse(log["odom"], log["gt_poses"], align=False)
    expect = {
        "update_ism": counts["updates"],
        "window_field": counts["refines"],
        "shift_stack": counts["refines"],
        "gather_rows": counts["resamples"],
    }
    elapsed = start.elapsed_time(end) / 1e3
    result = dict(
        scans=T, particles=pf.n_particles, map_dtype=pf.map_dtype,
        scans_per_sec=T / elapsed, seconds_cuda_events=elapsed,
        seconds_host=wall, ate_m=ate, ate_odom_m=ate_odom,
        host_reads_per_scan=counts["host_syncs"] / T, launches=launches,
        min_n_eff=float(n_eff.min()), **counts,
    )
    print("fastslam:", json.dumps(result))
    if not ate <= PF_MAX_ATE_M:
        raise AssertionError(f"ATE {ate} m above {PF_MAX_ATE_M} m: diverged")
    if counts["resamples"] < 1:
        raise AssertionError("no resample event")
    if launches != expect or min(launches.values()) <= 0:
        raise AssertionError(f"launches {launches}, expected {expect}")
    if counts["host_syncs"] > counts["refines"]:
        raise AssertionError("more than one host read per refine event")
    return launches


def pf_parity(cfg, pf, log, device):
    """Phase 7: at each of the first refine events, the same state and the
    same draws through the kernel step and through the plain step."""
    odom = torch.as_tensor(np.asarray(log["odom"], np.float32), device=device)
    ranges = torch.as_tensor(np.asarray(log["ranges"], np.float32), device=device)
    flags = fastslam.host_gate_flags(
        log["odom"], cfg, log["odom"][0], 0.0, np.inf, 0.0
    )
    last = int(np.nonzero(flags[:, 0])[0][PF_PARITY_REFINES - 1]) + 1
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 2)
    P = pf.n_particles
    noise = torch.randn((last, P, 3), generator=gen, device=device)
    u = torch.rand(last, generator=gen, device=device)
    state = fastslam.fastslam_init(cfg, pf, device, start_pose=log["odom"][0])
    worst = dict(pose=0.0, log_w=0.0, score=0.0, cells=0)
    for t in range(last):
        kw = dict(gates=flags[t], noise=noise[t], u=u[t])
        if flags[t, 0]:
            twin = state._replace(logodds=state.logodds.clone())
            ref, (_, _, ref_sc) = fastslam.fastslam_step(
                twin, odom[t], ranges[t], cfg, pf, plain=True, **kw
            )
        state, (_, _, sc) = fastslam.fastslam_step(
            state, odom[t], ranges[t], cfg, pf, **kw
        )
        if flags[t, 0]:
            dpose = (state.poses - ref.poses).abs()
            dpose[:, 2] = torch.remainder(dpose[:, 2] + np.pi, 2 * np.pi) - np.pi
            worst["pose"] = max(worst["pose"], float(dpose.abs().max()))
            worst["log_w"] = max(
                worst["log_w"], float((state.log_w - ref.log_w).abs().max())
            )
            worst["score"] = max(worst["score"], abs(float(sc - ref_sc)))
            cells, _ = _map_cells_ok(
                state.logodds, ref.logodds, cfg.grid, f"maps at scan {t}"
            )
            worst["cells"] = max(worst["cells"], cells)
    print(f"plain-version FastSLAM steps at the first {PF_PARITY_REFINES} "
          f"refine events (scans up to {last - 1}): max |dpose| "
          f"{worst['pose']:.3g}, max |dlog_w| {worst['log_w']:.3g}, max "
          f"|dscore| {worst['score']:.3g}, at most {worst['cells']} map cells "
          f"differ (tolerance {PF_POSE_TOL} m and rad, {PF_LOGW_TOL}, "
          f"{MAP_CELL_SHARE:.2%} of cells)")
    if worst["pose"] > PF_POSE_TOL or worst["log_w"] > PF_LOGW_TOL:
        raise AssertionError("kernel and plain FastSLAM steps disagree")


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: no CUDA device; it runs only on a GPU")
    device = torch.device("cuda", 0)
    print(card())
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    lib_path = _build.library_path()
    _build.load_library()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s: {lib_path}")

    cfg = bench_config()
    log = bench_log(cfg.sensor)
    pf_cfg, pf = pf_bench_config()
    pf_log = pf_bench_log(pf_cfg.sensor)
    checks = kernel_checks(cfg, log, device)
    checks.update(pf_kernel_checks(pf_cfg, pf, pf_log, device))
    traj, launches = run_slice(cfg, log, device)
    parity_run(cfg, log, device, traj)
    launches.update(run_pf(pf_cfg, pf, pf_log, device))
    pf_parity(pf_cfg, pf, pf_log, device)

    sources = {
        "update_hybrid": ("slam2d_tpu_torch/csrc/update_hybrid.cu",
                          "slam2d_tpu/ops/pallas_update.py:97"),
        "score_offsets": ("slam2d_tpu_torch/csrc/score.cu",
                          "slam2d_tpu/ops/pallas_score.py:29"),
        "search_space": ("slam2d_tpu_torch/csrc/search_space.cu",
                         "slam2d_tpu/ops/pallas_blur.py:34"),
        "update_ism": ("slam2d_tpu_torch/csrc/update_ism.cu",
                       "slam2d_tpu/ops/pallas_update.py:97"),
        "gather_rows": ("slam2d_tpu_torch/csrc/gather_rows.cu",
                        "slam2d_tpu/ops/pallas_gather.py:27"),
        "window_field": ("slam2d_tpu_torch/csrc/window_field.cu",
                         "slam2d_tpu/ops/pallas_field.py:46"),
        "shift_stack": ("slam2d_tpu_torch/csrc/shift_stack.cu",
                        "slam2d_tpu/ops/pallas_stack.py:31"),
    }
    kernels = [
        dict(name=name, route="cuda", source=src, replaces=rep,
             launches=launches[name], **checks[name])
        for name, (src, rep) in sources.items()
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
