"""The readings that the limits of a cell's check are set from, in one
process on the card: the program's runs over many seeds (the lower
readings) and the control's (the upper ones).

    python3 benchmark/control.py --workload frontend.dense \
        --seeds 101 102 103 --seconds 8 [--program] [--control]

For each seed, with `--program` one run of the cell (its window of
`--seconds`, its check), and with `--control` one run with the cell's
control in the program's place: the plain reference computed in the
nearest precision below the configuration's (benchmark/systems/*.py:
`Control`), judged by the same check. Prints one JSON line a run:
{"seed", "side", "checked", "attempted"}. Exits non-zero without a card.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import benchmark.run  # noqa: E402,F401  (the run's environment)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--program", action="store_true")
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)

    import torch

    from benchmark.harness import run_cell
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 3
    sides = [s for s, on in (("program", args.program),
                             ("control", args.control)) if on]
    for seed in args.seeds:
        for side in sides:
            r = run_cell(args.workload, seed, args.seconds, False,
                         t_start=time.perf_counter(),
                         device=torch.device("cuda", 0),
                         control=side == "control")
            print(json.dumps({"seed": seed, "side": side,
                              "checked": r["checked"],
                              "attempted": r["attempted"],
                              "metrics": r["metrics"]}), flush=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
