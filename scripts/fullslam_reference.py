#!/usr/bin/env python3
"""The JAX package's full SLAM at the port's full-SLAM bench config, as
the reference that chip_smoke.py's phase 15 holds the port to.

    python3 scripts/fullslam_reference.py [--out scripts/fullslam_reference.json]

Runs the JAX package's `run_full_slam` on the CPU over
`bench_configs.fullslam_bench_log` at `bench_configs.fullslam_bench_config`
(1024^2 at 0.05 m, 715 scans), with the map update the port runs
("pallas_hybrid", the JAX kernel in interpret mode; the JAX package's
"auto" would pick its sampled-ray update on the CPU), and writes the
keyframe scan indices, every loop attempt, the accepted loops, chi2 and
the ATEs as one JSON file. Phase 15 holds the port's keyframes and
attempt decisions equal to them and prints the rest beside its own.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

DEFAULT_OUT = os.path.join(ROOT, "scripts", "fullslam_reference.json")


def reference(out: str):
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=1").strip()
    import jax

    jax.config.update("jax_platforms", "cpu")
    from scripts.relocalization_reference import _to_jax
    from slam2d_tpu.metrics import ate_rmse
    from slam2d_tpu.run.full_slam import run_full_slam
    from slam2d_tpu_torch.run.bench_configs import (
        fullslam_bench_config,
        fullslam_bench_log,
    )

    cfg, gcfg = fullslam_bench_config()
    jcfg = _to_jax(cfg)
    jcfg = dataclasses.replace(
        jcfg, grid=dataclasses.replace(jcfg.grid, update_impl="pallas_hybrid"))
    log = fullslam_bench_log(cfg.sensor)
    t0 = time.perf_counter()
    res = run_full_slam(log, jcfg, _to_jax(gcfg))
    seconds = time.perf_counter() - t0
    gt = log["gt_poses"]
    idx = np.asarray(res.kf_scan_idx)
    result = dict(
        config="bench_configs.fullslam_bench_config / fullslam_bench_log, "
               "update_impl pallas_hybrid",
        jax=dict(version=jax.__version__, backend=jax.default_backend()),
        scans=len(log["odom"]), seconds=seconds,
        kf_scan_idx=idx.tolist(),
        kf_poses=np.asarray(res.kf_poses).tolist(),
        loop_attempts=np.asarray(res.loop_attempts).tolist(),
        loops=np.asarray(res.loops).tolist(),
        n_loops=int(res.n_loops), chi2=float(res.chi2),
        kf_ate_m=float(ate_rmse(res.kf_poses, gt[idx], align=False)),
        kf_ate_odom_m=float(ate_rmse(log["odom"][idx], gt[idx], align=False)),
        traj_ate_m=float(ate_rmse(res.traj, gt, align=False)),
        traj_ate_odom_m=float(ate_rmse(log["odom"], gt, align=False)),
    )
    print(json.dumps({k: v for k, v in result.items()
                      if k not in ("kf_poses", "loop_attempts", "loops",
                                   "kf_scan_idx")}))
    with open(out, "w") as f:
        json.dump(result, f, indent=1)
        f.write("\n")
    print(f"wrote {out}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=DEFAULT_OUT)
    reference(ap.parse_args().out)


if __name__ == "__main__":
    main()
