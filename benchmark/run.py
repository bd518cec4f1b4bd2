"""The benchmark of slam2d_tpu_torch: one run of one cell on the card.

    python3 benchmark/run.py --workload frontend.dense --seed 7 \
        --seconds 20 --trace 0

Runs from the root of a checkout. The cell, its configuration, traffic
mix and check are found by name (benchmark/bench.py). Prints the check's
numbers beside their limits as the last lines of standard error, and one
JSON object as the last line of standard output: `correct`, `attempted`,
`failed`, `metrics` (the cell's end-to-end metrics, or with `--trace 1`
its per-layer ones), `device`, with `--trace 1` `breakdown`, and last
`checked`. Exits non-zero, printing no result, without a CUDA card, with
fewer cards than the cell asks for, or where a JAX module or the JAX
package was loaded by the time the window closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
# the caches of the kernels' builds stay in the checkout, at fixed paths
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[var] = str(ROOT / ".bench_cache" / sub)
os.environ["USE_FLAX"] = "0"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from benchmark.bench import Bench
    from benchmark.harness import run_cell

    bench = Bench()
    chips = bench.cell(args.workload)["chips"]
    if not torch.cuda.is_available():
        print("benchmark: no CUDA device; the benchmark runs on the card "
              "only", file=sys.stderr)
        return 3
    if torch.cuda.device_count() < chips:
        print(f"benchmark: the cell needs {chips} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 3
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), t_start=T_START, bench=bench,
                      device=torch.device("cuda", 0))
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
