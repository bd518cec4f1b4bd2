#!/usr/bin/env python3
"""Drive the PyTorch port (slam2d_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

from the repository root. It needs a CUDA card, PyTorch built for CUDA and
nvcc; it imports nothing of JAX. Phases, each of which raises on failure:

1. the card: its name and power limit (nvidia-smi);
2. the build of every kernel in slam2d_tpu_torch/csrc/ (nvcc, sm_90a);
3. each kernel against its plain PyTorch version on the card, at the
   frontend's main-path shapes, with inputs made from a seed; both timed
   with CUDA events (median of 30 launches after warmup);
4. the frontend at bench.py's config and log (1024^2 grid at 0.05 m, 180
   beams, 1078 scans, chunk 64): finite trajectory, ATE below odometry,
   every kernel launched (updates, search-space builds and scorer passes
   counted against the gate decisions); scans/s, ATE, launch counts and
   host syncs;
5. the first 256 scans again with every kernel replaced by its plain
   version on the card: the poses must agree within 5e-3 m / 5e-3 rad.

Prints one JSON line with the kernels' numbers, then as its last line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from slam2d_tpu.config import (
    FrontendConfig,
    GridConfig,
    MatcherConfig,
    SensorConfig,
)
from slam2d_tpu.data.synth import SynthWorld, simulate_log
from slam2d_tpu.metrics import ate_rmse
from slam2d_tpu_torch.grid import occupancy
from slam2d_tpu_torch.grid.window import (
    extract_window,
    scan_window_cells,
    update_window_cells,
)
from slam2d_tpu_torch.match import correlative
from slam2d_tpu_torch.ops import _build
from slam2d_tpu_torch.ops.score import score_window
from slam2d_tpu_torch.ops.search_space import search_space
from slam2d_tpu_torch.ops.update import update_hybrid
from slam2d_tpu_torch.run.frontend import frontend_step, run_frontend

SEED = 0
KERNEL_TIMING_RUNS = 30
PARITY_SCANS = 256
POSE_TOL_M = 5e-3
POSE_TOL_RAD = 5e-3


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


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


def bench_config():
    """bench.py's frontend config (chunk 64)."""
    return FrontendConfig(
        sensor=SensorConfig(n_beams=180, max_range=12.0),
        grid=GridConfig(
            height=1024, width=1024, resolution=0.05, ray_samples=256,
            center_x=10.0, center_y=10.0,
        ),
        matcher=MatcherConfig(search_xy=0.3, search_theta=0.15, n_theta=13),
        chunk=64,
        match_min_motion=0.25,
    )


def bench_log(sensor):
    """bench.py's synthetic log (seed 0, 0.05 m steps, 1078 scans)."""
    world = SynthWorld.box_rooms(20.0)
    wp = np.array(
        [[3.0, 3.0], [3.0, 8.0], [8.0, 8.0], [12.0, 3.5], [16.0, 3.5],
         [17.0, 9.0], [12.0, 14.0], [9.0, 17.0], [4.0, 16.0], [3.0, 4.0]]
    )
    return simulate_log(world, wp, sensor, step=0.05, seed=SEED)


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


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: no CUDA device; it runs only on a GPU")
    device = torch.device("cuda", 0)
    card = _card()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    lib_path = _build.library_path()
    _build.load_library()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s: {lib_path}")

    cfg = bench_config()
    log = bench_log(cfg.sensor)
    checks = kernel_checks(cfg, log, device)
    traj, launches = run_slice(cfg, log, device)
    parity_run(cfg, log, device, traj)

    sources = {
        "update_hybrid": ("slam2d_tpu_torch/csrc/update_hybrid.cu",
                          "slam2d_tpu/ops/pallas_update.py:97"),
        "score_offsets": ("slam2d_tpu_torch/csrc/score.cu",
                          "slam2d_tpu/ops/pallas_score.py:29"),
        "search_space": ("slam2d_tpu_torch/csrc/search_space.cu",
                         "slam2d_tpu/ops/pallas_blur.py:34"),
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
