#!/usr/bin/env python3
"""The JAX package's `scripts/bench_ate.py` on the CPU, as the reference
that chip_smoke.py's phase 4 (b) holds `scripts/bench_ate_torch.py` to.

    python3 scripts/bench_ate_reference.py [--seeds 0 1 2] [--impl pallas_hybrid]
        [--out scripts/bench_ate_reference.json]

Runs `scripts/bench_ate.py <impl> <seed>` once a seed, each in a process
of its own and all at once, with JAX held to the CPU (the Pallas kernels
then run in interpret mode), and writes the JSON line each printed, with
its wall time and the JAX version, as one file. At 1024^2 and 1,024
scans a seed takes about half a minute and ~0.5 GB of host memory.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import importlib.metadata
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_OUT = os.path.join(ROOT, "scripts", "bench_ate_reference.json")

# Held to the CPU before the script imports anything of JAX.
_RUN = (
    "import os, runpy, sys\n"
    "os.environ['XLA_FLAGS'] = (os.environ.get('XLA_FLAGS', '')"
    " + ' --xla_force_host_platform_device_count=1').strip()\n"
    "import jax\n"
    "jax.config.update('jax_platforms', 'cpu')\n"
    "sys.argv = sys.argv[1:]\n"
    "runpy.run_path(sys.argv[0], run_name='__main__')\n"
)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--impl", default="pallas_hybrid")
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args(argv)

    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    script = os.path.join(ROOT, "scripts", "bench_ate.py")
    procs = []
    for seed in args.seeds:
        cmd = [sys.executable, "-c", _RUN, script, args.impl, str(seed)]
        procs.append((seed, time.perf_counter(),
                      subprocess.Popen(cmd, env=env, cwd=ROOT,
                                       stdout=subprocess.PIPE, text=True)))
    def finish(job):
        seed, t0, p = job
        out, _ = p.communicate()
        seconds = time.perf_counter() - t0
        if p.returncode != 0:
            raise SystemExit(f"bench_ate.py seed {seed}: exit {p.returncode}")
        line = [ln for ln in out.splitlines() if ln.startswith("{")][-1]
        return dict(json.loads(line), seconds=seconds)

    # each process's own wall time, whichever ends first
    with concurrent.futures.ThreadPoolExecutor(len(procs)) as pool:
        runs = list(pool.map(finish, procs))

    result = dict(
        script=f"scripts/bench_ate.py {args.impl} <seed>",
        jax=dict(version=importlib.metadata.version("jax"), backend="cpu"),
        runs=runs,
    )
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
        f.write("\n")
    print(json.dumps(result))


if __name__ == "__main__":
    main()
