#!/usr/bin/env python3
"""Where the port's run on the card parts from its run on the CPU.

    python3 scripts/device_parity_torch.py [--seed 4] [--scans 140]
        [--device cuda] [--out PATH]

Full SLAM's frontend at chip_smoke.py phase 15's config and log
(bench_configs.fullslam_bench_config, fullslam_bench_log(seed)) over its
first `--scans` scans, through the kernels' plain versions on both
devices (before the first loop attempt, full SLAM's trajectory is the
frontend's):

- free runs on the CPU and on `--device`: the first scan whose poses
  differ, the largest difference, and the keyframes each run admits
  (run/full_slam.py's rule: a keyframe where the pose has moved
  keyframe_dist or turned keyframe_angle since the last one), each with
  its margin past keyframe_dist;
- lockstep: from the CPU run's state before each scan, one step on each
  device, stage by stage, on the same inputs: the prior, the beam
  endpoints, each pass's endpoint positions and scores, each pass's
  argmax (the port's own functions, spied), the pose and the score; then
  the map update and the search-space rebuild of each device's step (the
  cells that differ, the largest difference) and, where the poses
  differ, the same from the CPU's pose on both devices ("iso").

Prints one JSON line for each scan where a stage differs, and a last
line with the free runs' summary and the first (scan, stage) of the
lockstep that differs. `--out` writes every scan's line and both free
trajectories as JSON lines. Needs no JAX; with `--device cpu` both sides
run on the CPU and nothing may differ (the script's own check).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from slam2d_tpu_torch.core import se2  # noqa: E402
from slam2d_tpu_torch.match import correlative as corr  # noqa: E402
from slam2d_tpu_torch.run import bench_configs as bc  # noqa: E402
from slam2d_tpu_torch.run import frontend as fe  # noqa: E402

CPU = torch.device("cpu")
SPIED = ("scan_endpoints_local", "endpoint_positions", "score_offsets",
         "_argmax3")


def keyframes(traj, gcfg):
    """(scan, moved - keyframe_dist) of each keyframe of a [T, 3] run."""
    last, out = None, []
    for i, p in enumerate(traj):
        if last is None:
            last = p
            out.append((i, 0.0))
            continue
        moved = np.hypot(*(p[:2] - last[:2]))
        rot = abs((p[2] - last[2] + np.pi) % (2 * np.pi) - np.pi)
        if moved >= gcfg.keyframe_dist or rot >= gcfg.keyframe_angle:
            last = p
            out.append((i, round(float(moved - gcfg.keyframe_dist), 7)))
    return out


def ulps(a, b) -> float:
    """Largest |a - b| in float32 ulps of the larger magnitude."""
    a = np.asarray(a, np.float32).ravel()
    b = np.asarray(b, np.float32).ravel()
    if a.size == 0:
        return 0.0
    sp = np.spacing(np.maximum(np.abs(a), np.abs(b)))
    return float(np.max(np.abs(a.astype(np.float64) - b) / sp))


class Spy:
    """Records what the spied functions of match/correlative.py return."""

    def __init__(self):
        self.rec = {}
        self.orig = {n: getattr(corr, n) for n in SPIED}
        for n, f in self.orig.items():
            setattr(corr, n, self._wrap(n, f))

    def _wrap(self, name, f):
        def g(*a, **k):
            r = f(*a, **k)
            rs = r if isinstance(r, tuple) else (r,)
            self.rec.setdefault(name, []).append(
                tuple(x.detach().cpu().clone() for x in rs))
            return r
        return g

    def close(self):
        for n, f in self.orig.items():
            setattr(corr, n, f)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=4)
    ap.add_argument("--scans", type=int, default=140)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("device_parity_torch.py: no CUDA device")
    torch.set_num_threads(2)
    cfg, gcfg = bc.fullslam_bench_config()
    log = bc.fullslam_bench_log(cfg.sensor, seed=args.seed)
    odom = np.asarray(log["odom"], np.float32)[: args.scans]
    ranges = np.asarray(log["ranges"], np.float32)[: args.scans]
    n = len(odom)
    t0 = time.perf_counter()

    def init(d):
        return fe.frontend_init(cfg, d, start_pose=odom[0],
                                start_odom=odom[0], plain=True)

    def free_run(d):
        st, out = init(d), []
        o, r = torch.as_tensor(odom, device=d), torch.as_tensor(ranges, device=d)
        for k in range(n):
            st, (pose, _) = fe.frontend_step(st, o[k], r[k], cfg, plain=True)
            out.append(pose)
        return torch.stack(out).cpu().numpy()

    free = {"cpu": free_run(CPU), "device": free_run(dev)}
    apart = np.abs(free["device"].astype(np.float64) - free["cpu"]).max(axis=1)
    summary = dict(
        seed=args.seed, scans=n, device=str(dev),
        free_first_apart=int(np.argmax(np.r_[apart > 0, True])),
        free_max_apart_m=float(apart.max()),
        keyframes_cpu=keyframes(free["cpu"], gcfg),
        keyframes_device=keyframes(free["device"], gcfg),
    )

    def clone_to(st, d):
        return fe.FrontendState(*(t.detach().to(d).clone() for t in st))

    def staged(st, k, d, spy):
        spy.rec.clear()
        o = torch.as_tensor(odom[k], device=d)
        r = torch.as_tensor(ranges[k], device=d)
        prior = se2.compose(st.pose, se2.between(st.prev_odom, o))
        st2, (pose, score) = fe.frontend_step(st, o, r, cfg, plain=True)
        return dict(spy.rec), prior.cpu().numpy(), pose.cpu().numpy(), \
            float(score), st2

    def maps_apart(a, b, row, key):
        la, lb = a.logodds.cpu(), b.logodds.cpu()
        row[f"{key}update_cells"] = int((la != lb).sum())
        row[f"{key}update_max"] = float((la - lb).abs().max())
        row[f"{key}rebuild_max"] = float(
            (a.search_space.cpu() - b.search_space.cpu()).abs().max())

    spy = Spy()
    lines, first = [], None
    st = init(CPU)
    try:
        for k in range(n):
            rc, pc, posec, scc, st_cpu = staged(clone_to(st, CPU), k, CPU, spy)
            rd, pd, posed, scd, st_dev = staged(clone_to(st, dev), k, dev,
                                                spy)
            row = {"scan": k, "prior_ulps": ulps(pc, pd)}
            # the device step runs its gated-off match too (the gate
            # selects the prior): compare the passes the CPU ran
            if "score_offsets" in rc:
                row["endpoints_ulps"] = ulps(rc["scan_endpoints_local"][0][0],
                                             rd["scan_endpoints_local"][0][0])
                for i, (a, b) in enumerate(zip(rc["endpoint_positions"],
                                               rd["endpoint_positions"])):
                    row[f"positions{i}_ulps"] = max(ulps(a[0], b[0]),
                                                    ulps(a[1], b[1]))
                for i, (a, b) in enumerate(zip(rc["score_offsets"],
                                               rd["score_offsets"])):
                    row[f"scores{i}_max"] = float(
                        (a[0].double() - b[0].double()).abs().max())
                for i, (a, b) in enumerate(zip(rc["_argmax3"],
                                               rd["_argmax3"])):
                    ia, ib = [int(x) for x in a], [int(x) for x in b]
                    row[f"argmax{i}"] = ia if ia == ib else [ia, ib]
            row["pose_m"] = float(np.abs(posec.astype(np.float64)
                                         - posed).max())
            row["score"] = scc - scd
            maps_apart(st_cpu, st_dev, row, "")
            if row["pose_m"] > 0:
                iso_c, iso_d = clone_to(st, CPU), clone_to(st, dev)
                one = torch.ones((), dtype=torch.bool)
                r_k = torch.as_tensor(ranges[k])
                pose_t = torch.as_tensor(posec)
                fe._update(iso_c, r_k, pose_t, one, cfg, True, True)
                fe._update(iso_d, r_k.to(dev), pose_t.to(dev), one.to(dev),
                           cfg, True, True)
                maps_apart(iso_c, iso_d, row, "iso_")
            differs = [s for s, v in row.items() if s != "scan" and (
                (isinstance(v, list) and isinstance(v[0], list))
                or (isinstance(v, (int, float)) and v != 0))]
            if differs:
                print(json.dumps(row), flush=True)
                if first is None:
                    first = (k, differs[0])
            lines.append(row)
            st = st_cpu
    finally:
        spy.close()
    summary["lockstep_first_apart"] = first
    summary["seconds"] = round(time.perf_counter() - t0, 1)
    if args.out:
        with open(args.out, "w") as f:
            for row in lines:
                f.write(json.dumps(row) + "\n")
            for name, tr in free.items():
                f.write(json.dumps({"free": name, "traj": tr.tolist()}) + "\n")
    print(json.dumps(summary), flush=True)


if __name__ == "__main__":
    main()
