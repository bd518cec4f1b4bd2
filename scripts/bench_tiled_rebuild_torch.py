#!/usr/bin/env python3
"""Time the tiled world's map rebuild (run/full_slam_tiled.py:
make_tiled_rebuild_fn) on one GPU (or `--device cpu`).

    python3 scripts/bench_tiled_rebuild_torch.py [--runs 7]
        [--configs killian,cli_defaults] [--device cuda] [--root DIR]

Keyframes every GraphConfig.keyframe_dist of travel along the ground
truth of the corridor lap (bench_configs.fullslam_tiled_bench_log), with
their scans, are integrated from fresh pools, as an accepted loop's
rebuild does: at tests/test_killian_scale.py's config (256^2 tiles at
0.1 m) and at the CLI's tile defaults (512^2 tiles at 0.05 m). Each
rebuild runs between two synchronizes; after two warm-up rebuilds the
median and the spread of `--runs` are printed, one JSON line a config
and region form, with the card's name and power limit. The rebuild's
windows go through the host-origin region ops it calls
(grid/tiles.py:gather_region, scatter_region: tile pieces found in the
host table) and, in place of them, through the tiled frontend's
device-origin ops (gather_region_t, scatter_region_t: the origin
uploaded, the slots looked up in the device coords), in the order host,
device, device, host; each form's pools must have the first host run's
bits. `--root` imports slam2d_tpu_torch from another checkout (to
compare two trees in one session).
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--runs", type=int, default=7)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--configs", default="killian,cli_defaults")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))

    import numpy as np
    import torch

    from slam2d_tpu_torch.grid import tiles
    from slam2d_tpu_torch.run import bench_configs
    from slam2d_tpu_torch.run import full_slam_tiled as fst

    def gather_device(grid, tcfg, origin_rc, size, table):
        origin = torch.tensor(origin_rc, dtype=torch.int32,
                              device=grid.tiles.device)
        return tiles.gather_region_t(grid, tcfg, origin, size)

    def scatter_device(grid, tcfg, window, origin_rc, table):
        origin = torch.tensor(origin_rc, dtype=torch.int32,
                              device=grid.tiles.device)
        return tiles.scatter_region_t(grid, tcfg, window, origin)

    forms = {"host": (fst.gather_region, fst.scatter_region),
             "device": (gather_device, scatter_device)}

    dev = torch.device(args.device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    card = (subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip() if dev.type == "cuda" else "cpu")
    configs = {
        "killian": bench_configs.fullslam_tiled_killian_config(),
        "cli_defaults": bench_configs.fullslam_tiled_bench_config(),
    }
    for name in args.configs.split(","):
        cfg, tcfg, gcfg = configs[name]
        log = bench_configs.fullslam_tiled_bench_log(cfg.sensor)
        gt = np.asarray(log["gt_poses"], np.float32)
        step = np.r_[0.0, np.hypot(*np.diff(gt[:, :2], axis=0).T)]
        travel = np.cumsum(step)
        picks = np.flatnonzero(np.diff(np.floor(
            travel / gcfg.keyframe_dist), prepend=-1.0) > 0)
        cap = gcfg.max_nodes
        picks = picks[:cap]
        n = len(picks)
        poses = np.zeros((cap, 3), np.float32)
        scans = np.zeros((cap, cfg.sensor.n_beams), np.float32)
        mask = np.zeros(cap, np.int32)
        poses[:n] = gt[picks]
        scans[:n] = np.asarray(log["ranges"], np.float32)[picks]
        mask[:n] = 1
        table = tiles.TileTable(tcfg)
        table.activate(tiles.tiled_init(tcfg, dev), tiles.required_tiles(
            poses[:n, :2], cfg.sensor.max_range + 2.0, tcfg))
        rebuild = fst.make_tiled_rebuild_fn(cfg, tcfg, cap, device=dev)
        ref = None
        for form in ("host", "device", "device", "host"):
            fst.gather_region, fst.scatter_region = forms[form]
            times = []
            for k in range(2 + args.runs):
                sync()
                t0 = time.perf_counter()
                grid, sgrid = rebuild(table, poses, scans, mask, n_active=n)
                sync()
                if k >= 2:
                    times.append((time.perf_counter() - t0) * 1e3)
            if ref is None:
                ref = (grid.tiles, sgrid.tiles)
            same = (torch.equal(grid.tiles.view(torch.int32),
                                ref[0].view(torch.int32))
                    and torch.equal(sgrid.tiles.view(torch.int32),
                                    ref[1].view(torch.int32)))
            print(json.dumps(dict(
                config=name, region_ops=form, card=card, keyframes=n,
                tile=tcfg.tile, active_tiles=len(table.slot_of),
                rebuild_ms_median=statistics.median(times),
                rebuild_ms_min=min(times), rebuild_ms_max=max(times),
                runs=args.runs, same_bits_as_host=same,
            )))
            if not same:
                sys.exit(f"{name}: the {form} region ops changed the pools")
        fst.gather_region, fst.scatter_region = forms["host"]

if __name__ == "__main__":
    main()
