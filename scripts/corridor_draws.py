#!/usr/bin/env python3
"""How far one run's accuracy on the corridor lap is a draw, for the JAX
package and the PyTorch port, on the CPU.

    python3 scripts/corridor_draws.py draws --package jax|port
        [--ulps=0,1,-1,...]
    python3 scripts/corridor_draws.py chunks

The config and log are chip_smoke.py phase 16's at the CLI's tile
defaults (bench_configs.fullslam_tiled_bench_config: 512^2 tiles at
0.05 m; fullslam_tiled_bench_log, 911 scans), the frontend alone: with no
loop attempt, full SLAM's trajectory there is the tiled frontend's. Both
packages run the hybrid map update (the JAX kernel in interpret mode);
the port runs on 2 CPU threads (its sums, so its draws, depend on the
thread count).

- draws: run_tiled_frontend of one package once for each `--ulps` entry
  k, the sensor's first beam angle (so every beam's) moved by k float32
  ulps; prints each run's trajectory ATE (unaligned), one JSON line a run.
- chunks: the JAX package's run chunk by chunk; from JAX's state at the
  start of each chunk the port runs the same chunk (its plain versions),
  and the largest pose difference within the chunk is printed, one JSON
  line a chunk, with the scan where it occurs.
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


def _setup(ulps: int = 0):
    """(JAX config, port config, JAX TileConfig, port TileConfig, log),
    the first beam angle moved by `ulps` float32 ulps in both configs."""
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
        cfg, grid=dataclasses.replace(cfg.grid, update_impl="pallas_hybrid"),
        sensor=dataclasses.replace(
            cfg.sensor, angle_min=float(a) if ulps else cfg.sensor.angle_min))
    return _to_jax(cfg), cfg, TileConfig(**dataclasses.asdict(tcfg)), tcfg, log


def draws(package: str, ulps: list[int]):
    from slam2d_tpu_torch.metrics import ate_rmse

    for k in ulps:
        jcfg, cfg, jtcfg, tcfg, log = _setup(k)
        if package == "jax":
            from slam2d_tpu.run.frontend_tiled import run_tiled_frontend

            _, traj, _ = run_tiled_frontend(log, jcfg, jtcfg)
        else:
            from slam2d_tpu_torch.run.frontend_tiled import run_tiled_frontend

            _, traj, _ = run_tiled_frontend(log, cfg, tcfg, device="cpu")
        print(json.dumps(dict(
            package=package, angle_min_ulps=k,
            traj_ate_m=ate_rmse(np.asarray(traj), log["gt_poses"],
                                align=False),
            ate_odom_m=ate_rmse(log["odom"], log["gt_poses"], align=False),
        )), flush=True)


def chunks():
    import jax
    import jax.numpy as jnp
    import torch

    from slam2d_tpu.grid import tiles as jtiles
    from slam2d_tpu.grid.window import blur_halo_cells
    from slam2d_tpu.run import frontend_tiled as jft
    from slam2d_tpu_torch.run import frontend_tiled as tft

    jcfg, cfg, jtcfg, tcfg, log = _setup()
    odom = np.asarray(log["odom"], np.float32)
    ranges = np.asarray(log["ranges"], np.float32)
    T, K = len(odom), cfg.chunk
    # run_tiled_frontend's host loop, a chunk at a time
    state = jft.tiled_frontend_init(jtcfg, start_pose=odom[0],
                                    start_odom=odom[0])
    table = jtiles.TileTable(jtcfg)
    chunk_fn = jft.make_tiled_chunk_fn(jcfg, jtcfg)
    reach = (cfg.sensor.max_range + cfg.matcher.search_xy
             + blur_halo_cells(jcfg.matcher, tcfg.resolution)
             * tcfg.resolution + 2.0)
    est, base = odom[0], odom[0]
    for s in range(0, T, K):
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
        pst, ptab = tft.tiled_state_from_numpy(list(start), tcfg, "cpu")
        out = torch.empty((K, 4))
        tft.run_tiled_chunk(pst, ptab, o, r, cfg, tcfg, out, plain=True)
        d = np.abs(out[:n, :3].numpy() - tr[:n])
        at = int(np.argmax(d.max(axis=1)))
        print(json.dumps(dict(
            first_scan=s, max_dxy_m=float(d[:, :2].max()),
            max_dtheta_rad=float(d[:, 2].max()), at_scan=s + at,
            max_dscore=float(np.abs(out[:n, 3].numpy() - sc[:n]).max()),
        )), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", choices=("draws", "chunks"))
    ap.add_argument("--package", choices=("jax", "port"), default="port")
    ap.add_argument("--ulps", default="0,1,-1,2,-2,3,-3,4,-4,5,-5,6,-6")
    args = ap.parse_args()
    if args.mode == "draws":
        draws(args.package, [int(k) for k in args.ulps.split(",")])
    else:
        chunks()


if __name__ == "__main__":
    main()
