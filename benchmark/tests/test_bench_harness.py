"""Whole runs of the harness on the CPU at a tiny size (tiny.py): the
program's runs come out correct; the control (the reference in the next
lower precision in the program's place) and each fault the cells can
have, planted under the timed path, come out not correct. And the command
refuses to run without a card."""

import json
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from benchmark.bench import ROOT, Bench
from benchmark.harness import run_cell
from benchmark.tests import tiny


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    torch.set_num_threads(1)
    root = tiny.make(tmp_path_factory.mktemp("tiny"))
    return Bench(root / "BENCHMARK.json", root)


def _run(bench, cell, **kw):
    logs = []
    result = run_cell(cell, kw.pop("seed", 2**31 + 77), kw.pop("seconds", 2.0),
                      kw.pop("trace", False), t_start=time.perf_counter(),
                      bench=bench, device="cpu",
                      log=lambda *a, **k: logs.append(a[0]), **kw)
    return result, logs


@pytest.mark.parametrize("cell", ["fe.tiny", "pf.tiny"])
def test_program_correct(bench, cell):
    r, logs = _run(bench, cell)
    assert r["correct"], r["checked"]
    assert list(r)[-1] == "checked" and r["attempted"] > 0
    assert logs[-1].startswith("check ")
    assert set(r["metrics"]) == {"scans_per_s", "setup_s"}


@pytest.mark.parametrize("cell", ["fe.tiny", "pf.tiny"])
def test_traced_run(bench, cell):
    r, _ = _run(bench, cell, trace=True, seconds=8.0)
    assert r["correct"]
    assert "busy_s" in r["device"] and "window_s" in r["device"]
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    # the CPU trace has no device operation: the readers of the device's
    # timeline find nothing to read
    assert set(r["metrics"]) == {"host_reads_per_scan"}


@pytest.mark.parametrize("cell", ["fe.tiny", "pf.tiny"])
def test_control_not_correct(bench, cell):
    r, _ = _run(bench, cell, control=True)
    assert not r["correct"], r["checked"]


def _fault(monkeypatch, bench, cell, kind):
    """Plant `kind` under the system's entry."""
    cfg = bench.config(bench.cell(cell)["config"])
    System = bench.system(cfg)
    orig = System.run_chunk

    def run_chunk(self, sess, c):
        before = None if sess["state"] is None else sess["state"]
        maps = None if before is None else before.logodds.clone()
        out = orig(self, sess, c)
        st = sess["state"]
        if kind == "state unchanged":
            st.logodds.copy_(torch.zeros_like(st.logodds) if maps is None
                             else maps)
        elif kind == "half the batch":
            P = st.logodds.shape[0]
            old = torch.zeros_like(st.logodds) if maps is None else maps
            st.logodds[P // 2:] = old[P // 2:]
        elif kind == "answer altered":
            out = out.copy()
            out[:, 0] += 0.01
        return out

    monkeypatch.setattr(System, "run_chunk", run_chunk)


@pytest.mark.parametrize("cell,kind", [
    ("fe.tiny", "state unchanged"), ("fe.tiny", "answer altered"),
    ("pf.tiny", "state unchanged"), ("pf.tiny", "half the batch"),
    ("pf.tiny", "answer altered")])
def test_fault_not_correct(bench, monkeypatch, cell, kind):
    _fault(monkeypatch, bench, cell, kind)
    r, _ = _run(bench, cell)
    assert not r["correct"], (kind, r["checked"])


def test_seeds_same_inputs(bench):
    cfg = bench.config("pf_tiny")
    System = bench.system(cfg)
    a = System(cfg, bench.mix("tiny"), 2**31 + 3, "cpu")
    b = System(cfg, bench.mix("tiny"), 2**31 + 3, "cpu")
    c = System(cfg, bench.mix("tiny"), 2**31 + 4, "cpu")
    assert np.array_equal(a.log["ranges"], b.log["ranges"])
    assert torch.equal(a.noise, b.noise) and not torch.equal(a.noise, c.noise)
    assert len(a.log["odom"]) == len(c.log["odom"])


def test_no_card_no_result():
    """Without a card (this CPU build of PyTorch sees none) the command
    exits non-zero and prints no result line."""
    env = {"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
           "HOME": str(ROOT)}
    p = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "frontend.dense",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert not any(line.startswith("{") for line in p.stdout.splitlines())
    assert "no CUDA device" in p.stderr


def test_bare_checkout_fails(tmp_path):
    """In a directory holding only BENCHMARK.json and benchmark/ the
    command exits non-zero and prints no result (the program is not
    there)."""
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "frontend.dense",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert not any(line.startswith("{") for line in p.stdout.splitlines())
    json.loads((tmp_path / "BENCHMARK.json").read_text())
