"""A tiny copy of the benchmark's data for the CPU tests: the four
cells' configurations cut to a 256^2 frontend map and four particles on
128^2 maps, 61 beams of 6 m, chunks of 8 scans, one short lap of the
box-rooms world; the real systems' and readers' files, copied."""

import json
import pathlib
import shutil

SRC = pathlib.Path(__file__).resolve().parent.parent
ROOT = SRC.parent
CELLS = {"frontend.dense": "fe.tiny", "frontend.sparse": "fe.tiny",
         "pf100.dense": "pf.tiny", "pf100.sparse": "pf.tiny"}


def make(root: pathlib.Path) -> pathlib.Path:
    """The data directory under `root`, with its BENCHMARK.json."""
    for d in ("configs", "traffic", "cells"):
        (root / d).mkdir(parents=True, exist_ok=True)
    for d in ("systems", "metrics"):
        shutil.copytree(SRC / d, root / d)
    fe = json.loads((SRC / "configs/frontend_1024.json").read_text())
    fe["sensor"].update(n_beams=61, max_range=6.0)
    fe["grid"].update(height=256, width=256, resolution=0.1, ray_samples=64)
    fe["frontend"].update(chunk=8, bootstrap_dist=1.0)
    pf = json.loads((SRC / "configs/fastslam100_512.json").read_text())
    pf["sensor"].update(n_beams=61, max_range=6.0)
    pf["grid"].update(height=128, width=128, resolution=0.2, ray_samples=32)
    pf["frontend"].update(chunk=8, bootstrap_dist=1.0)
    pf["pf"].update(n_particles=4, refine_shared_min_particles=2)
    (root / "configs/fe_tiny.json").write_text(json.dumps(fe))
    (root / "configs/pf_tiny.json").write_text(json.dumps(pf))
    mix = json.loads((SRC / "traffic/dense.json").read_text())
    mix.update(route=[[3.0, 3.0], [3.0, 8.0], [8.0, 8.0]], laps=1,
               step_m=0.15)
    (root / "traffic/tiny.json").write_text(json.dumps(mix))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec["workloads"] = [
        {"name": "fe.tiny", "config": "fe_tiny", "traffic": "tiny",
         "chips": 1, "why": "test"},
        {"name": "pf.tiny", "config": "pf_tiny", "traffic": "tiny",
         "chips": 1, "why": "test"}]
    for m in spec["per_layer"]:
        m["workloads"] = sorted({CELLS[w] for w in m["workloads"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    common = {"check_chunks_per_session": 2, "trace_first_chunk": 1,
              "trace_chunks": 2}
    (root / "cells/fe.tiny.json").write_text(json.dumps(dict(
        common, limits={"pose_miss": 0.0, "cell_miss": 0.0})))
    (root / "cells/pf.tiny.json").write_text(json.dumps(dict(
        common, limits={"particle_miss": 0.0, "cell_miss": 0.0,
                        "best_miss": 0.0})))
    return root
