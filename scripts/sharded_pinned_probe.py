#!/usr/bin/env python3
"""Where chip_smoke.py phase 22 (b)'s pinned four-rank run parts from the
single-device run, on one GPU.

    python3 scripts/sharded_pinned_probe.py TREE SEED [SEED ...]

TREE is the root of a checkout whose slam2d_tpu_torch is imported (the
repository itself, or another commit unpacked beside it, to compare two
trees in one call). For each PF seed: FastSLAM-1000 over the first 512
scans of bench_pf's log with the modes pinned per particle, once on
cuda:0 (run_fastslam, host-gated) and once over four gloo ranks sharing
the card (run_sharded_fastslam), as phase 22 (b) runs them. Prints one
JSON line a seed: the largest best-pose difference over every scan and
over the scans that do not resample, the first scan where the poses
differ, the eight largest differences with whether their scan resampled,
the resample scans of both runs (where the next scan's N_eff is back at P
and this one's is below half), both unaligned ATEs, and the seconds.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.abspath(sys.argv[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from slam2d_tpu_torch.metrics import ate_rmse  # noqa: E402
from slam2d_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from slam2d_tpu_torch.run.bench_configs import (  # noqa: E402
    pf1000_bench_config,
    pf_bench_log,
)
from slam2d_tpu_torch.run.fastslam_run import run_fastslam  # noqa: E402
from slam2d_tpu_torch.run.sharded_run import run_sharded_fastslam  # noqa: E402

SCANS = 512   # phase 22 (b)'s MD_SCANS
RANKS = 4


def four_ranks(mesh, log, cfg, pf, seed):
    _, traj, n_eff, _ = run_sharded_fastslam(log, cfg, pf, seed=seed,
                                             mesh=mesh)
    return dict(traj=traj, n_eff=n_eff)


def resample_scans(n_eff, P):
    return [i for i in range(len(n_eff) - 1)
            if n_eff[i + 1] > 0.99 * P and n_eff[i] < 0.5 * P]


def main():
    cfg, pf = pf1000_bench_config()
    log = {k: np.asarray(v)[:SCANS]
           for k, v in pf_bench_log(cfg.sensor).items()}
    pinned = dataclasses.replace(pf, refine_mode="per_particle",
                                 update_mode="per_particle")
    dev = torch.device("cuda", 0)
    P = pinned.n_particles
    for seed in (int(x) for x in sys.argv[2:]):
        t0 = time.perf_counter()
        _, one, ne_one, _ = run_fastslam(log, cfg, pinned, dev, seed=seed,
                                         host_gated=True)
        (r0, *_) = pmesh.spawn(four_ranks, RANKS, "gloo", "cuda:0",
                               args=(log, cfg, pinned, seed))
        four, ne_four = r0["traj"], r0["n_eff"]
        d = np.hypot(*(four[:, :2] - one[:, :2]).T)
        res_one = resample_scans(ne_one, P)
        other = np.array([i not in res_one for i in range(len(d))])
        apart = d > 0
        print(json.dumps(dict(
            seed=seed, max_dxy=float(d.max()),
            max_dxy_nonresample=float(d[other].max()),
            first_apart=int(np.argmax(apart)) if apart.any() else -1,
            top=[(int(i), float(d[i]), bool(i in res_one))
                 for i in np.argsort(-d)[:8]],
            resamples_1=res_one, resamples_4=resample_scans(ne_four, P),
            ate_1=float(ate_rmse(one, log["gt_poses"], align=False)),
            ate_4=float(ate_rmse(four, log["gt_poses"], align=False)),
            seconds=time.perf_counter() - t0)), flush=True)


if __name__ == "__main__":
    main()
