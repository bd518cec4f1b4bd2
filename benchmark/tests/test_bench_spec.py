"""BENCHMARK.json against the contract's shape, and every cell, config,
mix and metric found by name; a new file is picked up with no edit."""

import json
import math
import re
import shutil

import pytest

from benchmark.bench import DATA, NAME, ROOT, UNIT, Bench

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
LINE = re.compile(r"^[^\t\n]{1,200}$")


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_names_and_units(kind):
    names = [e["name"] for e in SPEC[kind]]
    assert len(set(names)) == len(names)
    for e in SPEC[kind]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert LINE.match(e[key]), (e["name"], key)


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_cell_resolves(cell):
    b = Bench()
    w = b.cell(cell)
    assert w["chips"] == 1
    cfg, mix, params = b.config(w["config"]), b.mix(w["traffic"]), \
        b.cell_params(cell)
    assert b.system(cfg).__name__ == "System"
    assert mix["laps"] >= 1 and mix["step_m"] > 0
    assert set(params["limits"]) and params["trace_chunks"] >= 2
    e2e = {m["name"] for m in b.metrics(cell, "end_to_end")}
    assert {"setup_s", "scans_per_s"} <= e2e
    layer = b.metrics(cell, "per_layer")
    assert layer
    for m in layer:
        assert callable(b.reader(m["name"]))
        assert m["moves"] in e2e


def test_configs_files():
    for c in SPEC["configs"]:
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert c["reduced"] == cfg["reduced"]
        assert c["source"] == cfg["source"]
        assert c["source"].startswith("https://")


def test_bounds():
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert "bound" not in m
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_full_check_fits():
    n = 24
    runs = 2 + 14 * n
    assert runs * (SPEC["run_seconds"] + 60) + n * 180 + 1200 <= 43200


@pytest.mark.parametrize("kind", ["configs", "traffic", "metrics"])
def test_new_file_picked_up(tmp_path, kind):
    data = tmp_path / "data"
    shutil.copytree(DATA, data, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    if kind == "configs":
        cfg = json.loads((data / "configs/frontend_1024.json").read_text())
        cfg["grid"]["resolution"] = 0.1
        (data / "configs/frontend_copy.json").write_text(json.dumps(cfg))
        spec["workloads"].append({"name": "copy.dense",
                                  "config": "frontend_copy",
                                  "traffic": "dense", "chips": 1,
                                  "why": "test"})
    elif kind == "traffic":
        mix = json.loads((data / "traffic/dense.json").read_text())
        mix["step_m"] = 0.1
        (data / "traffic/medium.json").write_text(json.dumps(mix))
        spec["workloads"].append({"name": "copy.dense", "config":
                                  "frontend_1024", "traffic": "medium",
                                  "chips": 1, "why": "test"})
    else:
        (data / "metrics/scans_traced.py").write_text(
            "def read(ctx):\n    return ctx.scans_traced\n")
        spec["per_layer"].append({
            "name": "scans_traced", "unit": "scans", "better": "higher",
            "source": "program_counter", "layer": "driver",
            "moves": "scans_per_s", "workloads": ["frontend.dense"]})
    (data / "cells/copy.dense.json").write_text(
        (data / "cells/frontend.dense.json").read_text())
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    b = Bench(tmp_path / "BENCHMARK.json", data)
    if kind == "metrics":
        ctx = type("Ctx", (), {"scans_traced": 7})()
        assert b.reader("scans_traced")(ctx) == 7
        assert "scans_traced" in [m["name"] for m in
                                  b.metrics("frontend.dense", "per_layer")]
        return
    w = b.cell("copy.dense")
    cfg, mix = b.config(w["config"]), b.mix(w["traffic"])
    assert b.system(cfg).__name__ == "System"
    assert math.isfinite(mix["step_m"])
