#!/usr/bin/env python3
"""The JAX package's relocalization on the PyTorch port's frontend map, as
the reference that chip_smoke.py's phase 14 holds the port to.

    python3 scripts/relocalization_reference.py map --out MAP.npy
    python3 scripts/relocalization_reference.py reference MAP.npy \\
        [--out scripts/relocalization_reference.json]

`map` (on a GPU, the port only): runs the port's frontend over bench.py's
log at its config, as chip_smoke.py's phase 4 does, and saves the final
log-odds map (float32 [1024, 1024]); prints its sha256.

`reference` (on the CPU, the JAX package): on that map,
  - `global_localize` at phase 14's drawn scans of the localization log
    (`chip_smoke.global_picks`): the coarse sweep's cell and heading
    (refine=False), its score, and the refined pose, score and margin;
  - `run_localization(recover=True)` over the kidnap log: the events,
    the scans that reported exactly -1 (skipped), and the ATE;
and writes them with the map's sha256 as one JSON file. Phase 14 uses
them only on a map of that sha256. The sweep holds [72, 1536, 1536]
float32 and its transforms: about 3 GB of host memory.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

DEFAULT_OUT = os.path.join(ROOT, "scripts", "relocalization_reference.json")


def map_sha256(logodds: np.ndarray) -> str:
    """sha256 of a map's float32 cells in C order."""
    a = np.ascontiguousarray(np.asarray(logodds, np.float32))
    return hashlib.sha256(a.tobytes()).hexdigest()


def save_map(out: str):
    import torch

    from slam2d_tpu_torch.run.bench_configs import bench_config, bench_log, card
    from slam2d_tpu_torch.run.frontend import run_frontend

    cfg = bench_config()
    state, _, _ = run_frontend(bench_log(cfg.sensor), cfg,
                               torch.device("cuda", 0))
    logodds = state.logodds.cpu().numpy()
    np.save(out, logodds)
    print(card())
    print(json.dumps({"map": out, "shape": list(logodds.shape),
                      "sha256": map_sha256(logodds)}))


def _to_jax(cfg):
    """The JAX package's config dataclass of the same name as the port's
    `cfg`, field by field."""
    from slam2d_tpu import config as jax_config

    cls = getattr(jax_config, type(cfg).__name__)
    return cls(**{
        f.name: _to_jax(v) if dataclasses.is_dataclass(v) else v
        for f in dataclasses.fields(cfg)
        for v in (getattr(cfg, f.name),)
    })


def reference(map_path: str, out: str):
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=1").strip()
    import jax

    jax.config.update("jax_platforms", "cpu")
    from chip_smoke import global_picks
    from slam2d_tpu.match.global_loc import global_localize
    from slam2d_tpu.metrics import ate_rmse
    from slam2d_tpu.run.frontend import run_localization
    from slam2d_tpu_torch.match.global_loc import sweep_cell
    from slam2d_tpu_torch.run.bench_configs import (
        bench_config,
        kidnap_log,
        localization_log,
    )

    cfg = bench_config()
    jcfg = _to_jax(cfg)
    g, m, s = jcfg.grid, jcfg.matcher, jcfg.sensor
    logodds = np.load(map_path).astype(np.float32)
    if logodds.shape != (g.height, g.width):
        raise SystemExit(f"map {logodds.shape} is not bench.py's grid")
    loc_log = localization_log(cfg.sensor)
    rows = []
    for i in global_picks(len(loc_log["odom"])):
        r = np.asarray(loc_log["ranges"][i], np.float32)
        coarse, cscore = global_localize(logodds, r, g, m, s, refine=False)
        pose, score, margin = global_localize(logodds, r, g, m, s,
                                              return_margin=True)
        rows.append(dict(
            scan=int(i), coarse_cell=list(sweep_cell(np.asarray(coarse),
                                                      cfg.grid)),
            coarse_pose=np.asarray(coarse).tolist(),
            coarse_score=float(cscore), pose=np.asarray(pose).tolist(),
            score=float(score), margin=float(margin),
        ))
        print("global_localize:", json.dumps(rows[-1]), flush=True)
    kidnap = kidnap_log(cfg.sensor)
    _, traj, scores, events = run_localization(kidnap, jcfg, logodds,
                                               recover=True)
    recovery = dict(
        events=events,
        skipped=np.flatnonzero(np.asarray(scores) == -1.0).tolist(),
        ate_m=float(ate_rmse(traj, kidnap["gt_poses"], align=False)),
    )
    print("recovery:", json.dumps(dict(events=events,
                                       ate_m=recovery["ate_m"])))
    result = dict(
        map=dict(sha256=map_sha256(logodds), shape=list(logodds.shape),
                 made_by="scripts/relocalization_reference.py map"),
        jax=dict(version=jax.__version__, backend=jax.default_backend()),
        global_localize=rows, recovery=recovery,
    )
    with open(out, "w") as f:
        json.dump(result, f, indent=1)
        f.write("\n")
    print(f"wrote {out}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="mode", required=True)
    a = sub.add_parser("map")
    a.add_argument("--out", required=True)
    b = sub.add_parser("reference")
    b.add_argument("map")
    b.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args()
    if args.mode == "map":
        save_map(args.out)
    else:
        reference(args.map, args.out)


if __name__ == "__main__":
    main()
