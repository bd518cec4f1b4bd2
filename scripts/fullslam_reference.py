#!/usr/bin/env python3
"""The JAX package's full SLAM at the port's full-SLAM bench configs, as
the references that chip_smoke.py's phases 15-17 hold the port to.

    python3 scripts/fullslam_reference.py [--run NAME] [--out PATH]

Runs the JAX package on the CPU, with the map update the port's run
takes ("pallas_hybrid", the JAX kernel in interpret mode, or, for
sparse_hier, "sparse"; the JAX package's "auto" would pick its
sampled-ray update on the CPU), and writes the
keyframe scan indices, every loop attempt, the accepted loops, chi2 and
the ATEs as one JSON file. The runs (--run, each with its own default
file under scripts/):

- bench (fullslam_reference.json): `run_full_slam` at
  `bench_configs.fullslam_bench_config` over `fullslam_bench_log`
  (1024^2 at 0.05 m, 715 scans; ~4.5 min, ~1 GB);
- schur (fullslam_reference_schur.json): the same with
  optimizer="schur" (phase 17);
- sparse_hier (fullslam_reference_sparse_hier.json): the same with the
  sampled-ray update (update_impl "sparse", the JAX package's XLA
  scatter-add) and optimizer="hier" at GraphConfig.hier_dense_max=64,
  so that every solve runs the V-cycle (phase 19);
- seed4 to seed7 (fullslam_reference_seed4.json to _seed7.json): the
  dense run over `fullslam_bench_log(seed=4 .. 7)`, the same route with
  other noise (phase 15's five-seed set with bench);
- tiled (fullslam_tiled_reference.json): `run_full_slam_tiled` at
  `bench_configs.fullslam_tiled_bench_config` over
  `fullslam_tiled_bench_log` (512^2 tiles at 0.05 m, a 911-scan lap of
  the 60 m corridor; phase 16), with the active tiles;
- tiled_seed4 to tiled_seed7 (fullslam_tiled_reference_seed4.json to
  _seed7.json): the same over `fullslam_tiled_bench_log(seed=4 .. 7)`,
  the same lap with other noise (phase 16's five-seed set with tiled);
- killian (fullslam_tiled_killian_reference.json): the same log at
  `bench_configs.fullslam_tiled_killian_config`, tests/test_killian_scale
  .py's (256^2 tiles at 0.1 m; phase 16's second run).

Each phase holds the port's keyframe ATE to at most the run's + 0.1 m
and prints the keyframes, the attempt decisions and the rest beside
its own (the packages part late in a long log: rounding in the map
update's atan2 and in the scorer's sums grows into other anchors and
decisions). The new files (every run but `bench`) keep each list on one
line.
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

RUNS = {
    "bench": ("fullslam_reference.json", dict(seed=3, optimizer="dense")),
    "schur": ("fullslam_reference_schur.json",
              dict(seed=3, optimizer="schur")),
    "sparse_hier": ("fullslam_reference_sparse_hier.json",
                    dict(seed=3, optimizer="hier", update="sparse",
                         graph=dict(hier_dense_max=64))),
    "seed4": ("fullslam_reference_seed4.json", dict(seed=4, optimizer="dense")),
    "seed5": ("fullslam_reference_seed5.json", dict(seed=5, optimizer="dense")),
    "seed6": ("fullslam_reference_seed6.json", dict(seed=6, optimizer="dense")),
    "seed7": ("fullslam_reference_seed7.json", dict(seed=7, optimizer="dense")),
    "tiled": ("fullslam_tiled_reference.json",
              dict(tiled="fullslam_tiled_bench_config")),
    **{f"tiled_seed{k}": (f"fullslam_tiled_reference_seed{k}.json",
                          dict(tiled="fullslam_tiled_bench_config", seed=k))
       for k in (4, 5, 6, 7)},
    "killian": ("fullslam_tiled_killian_reference.json",
                dict(tiled="fullslam_tiled_killian_config")),
}
DEFAULT_OUT = os.path.join(ROOT, "scripts", RUNS["bench"][0])


def _one_run(run: str) -> dict:
    """The JAX package's run `run` on the CPU; its result as a dict of
    lists and floats."""
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=1").strip()
    import jax

    jax.config.update("jax_platforms", "cpu")
    from scripts.relocalization_reference import _to_jax
    from slam2d_tpu.metrics import ate_rmse
    from slam2d_tpu_torch.run import bench_configs as bc

    kw = RUNS[run][1]
    if kw.get("tiled"):
        from slam2d_tpu.grid.tiles import FREE_SLOT, TileConfig
        from slam2d_tpu.run.full_slam_tiled import run_full_slam_tiled

        cfg, tcfg, gcfg = getattr(bc, kw["tiled"])()
        seed = kw.get("seed", 3)
        log = bc.fullslam_tiled_bench_log(cfg.sensor, seed=seed)
        config = f"bench_configs.{kw['tiled']} / fullslam_tiled_bench_log"
        if seed != 3:
            config += f"(seed={seed})"

        def run_it(jcfg):
            return run_full_slam_tiled(
                log, jcfg, TileConfig(**dataclasses.asdict(tcfg)),
                _to_jax(gcfg))
    else:
        from slam2d_tpu.run.full_slam import run_full_slam

        cfg, gcfg = bc.fullslam_bench_config()
        log = bc.fullslam_bench_log(cfg.sensor, seed=kw["seed"])
        config = "bench_configs.fullslam_bench_config / fullslam_bench_log"
        if kw["seed"] != 3:
            config += f"(seed={kw['seed']})"
        if kw["optimizer"] != "dense":
            config += f", optimizer {kw['optimizer']}"
        if kw.get("graph"):
            gcfg = dataclasses.replace(gcfg, **kw["graph"])
            config += "".join(f", {k} {v}" for k, v in kw["graph"].items())

        def run_it(jcfg):
            return run_full_slam(log, jcfg, _to_jax(gcfg),
                                 optimizer=kw["optimizer"])

    update = kw.get("update", "pallas_hybrid")
    jcfg = _to_jax(cfg)
    jcfg = dataclasses.replace(
        jcfg, grid=dataclasses.replace(jcfg.grid, update_impl=update))
    t0 = time.perf_counter()
    res = run_it(jcfg)
    seconds = time.perf_counter() - t0
    gt = log["gt_poses"]
    idx = np.asarray(res.kf_scan_idx)
    result = dict(
        config=config + f", update_impl {update}",
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
    if kw.get("tiled"):
        coords = np.asarray(res.grid.coords)[:-1]
        result["active_tiles"] = int((coords[:, 0] > FREE_SLOT).sum())
    return result


def reference(run: str, out: str):
    """Write run `run`'s JSON to `out` (the bench run as it always was,
    the others with each list on one line)."""
    result = _one_run(run)
    print(json.dumps({k: v for k, v in result.items()
                      if k not in ("kf_poses", "loop_attempts", "loops",
                                   "kf_scan_idx")}))
    with open(out, "w") as f:
        if run == "bench":
            json.dump(result, f, indent=1)
        else:
            f.write("{\n" + ",\n".join(
                f" {json.dumps(k)}: {json.dumps(v)}"
                for k, v in result.items()) + "\n}")
        f.write("\n")
    print(f"wrote {out}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--run", choices=sorted(RUNS), default="bench")
    ap.add_argument("--out", default=None,
                    help="the JSON file (default: the run's, under scripts/)")
    args = ap.parse_args()
    reference(args.run, args.out or os.path.join(ROOT, "scripts",
                                                  RUNS[args.run][0]))


if __name__ == "__main__":
    main()
