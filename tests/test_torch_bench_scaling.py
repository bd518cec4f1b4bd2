"""bench_scaling_torch.py, the PyTorch port's twin of bench_scaling.py, in
its CPU test mode: gloo ranks at 1 and 2 on a tiny grid print
bench_scaling.py's lines with their keys, label the run as structure
(the ranks share the CPU), import neither JAX nor the JAX package; the
1-rank trajectory is run_sharded_fastslam's at 1 rank; a backend the
machine cannot give (CUDA without a card) raises."""

import json
import os
import subprocess
import sys
import textwrap
from types import SimpleNamespace

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import bench_scaling_torch as bst  # noqa: E402
from slam2d_tpu_torch.config import PFConfig  # noqa: E402
from slam2d_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from slam2d_tpu_torch.run.sharded_run import run_sharded_fastslam  # noqa: E402

TAGS = {"backend", "ranks_share_device", "scaling",
        "bytes_staged_per_scan_per_rank", "device"}
KEYS = {
    "sharded_pf_scans_per_sec": {
        "metric", "devices", "particles", "value", "unit", "cpu_seconds",
        "host_cpu_utilization", "host_cores", "scans", "resamples",
        "ring_hops"} | TAGS,
    "ancestor_ring_distance_histogram": {
        "metric", "devices", "histogram", "frac_zero_hops"} | TAGS,
    "per_collective_step_cost_us": {
        "metric", "devices", "normalize_psum", "cdf_all_gather",
        "best_pose_all_gather", "ring_ppermute_hop"} | TAGS,
    "collectives_only_steps_per_sec": {
        "metric", "devices", "value", "unit"} | TAGS,
    "collectives_only_production_cadence_steps_per_sec": {
        "metric", "devices", "value", "unit"} | TAGS,
    "weak_scaling_efficiency": {
        "metric", "value", "unit", "vs_baseline", "ranks_share_device",
        "scaling", "device"},
    "weak_scaling_evidence": {
        "metric", "collectives_only_efficiency",
        "collectives_production_cadence_efficiency",
        "collectives_efficiency_base_devices", "cpu_seconds_per_scan_growth",
        "width_growth", "host_cpu_utilization", "host_cores", "host_bound",
        "bytes_staged_per_scan_per_rank", "ranks_share_device", "scaling",
        "interpretation", "device"},
}


def test_bench_scaling_torch_cpu_mode_prints_the_lines():
    code = textwrap.dedent(
        """
        import runpy, sys
        sys.argv = ["bench_scaling_torch.py", "--device", "cpu", "--ranks",
                    "1", "2", "--grid", "64", "--scans", "32"]
        try:
            runpy.run_path("bench_scaling_torch.py", run_name="__main__")
        except SystemExit as e:
            assert not e.code, e.code
        print("jax" in sys.modules, "slam2d_tpu" in sys.modules)
        """
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=600, cwd=ROOT,
    )
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert lines[-1] == "False False"
    res = [json.loads(x) for x in lines if x.startswith("{")]
    assert [r["metric"] for r in res] == [
        *[m for _ in (1, 2) for m in list(KEYS)[:5]], *list(KEYS)[5:]]
    for r in res:
        assert set(r) == KEYS[r["metric"]], r["metric"]
        assert r["scaling"] == "structure"
        assert r["device"] == {"name": "cpu", "power_limit": None}
    per_mesh = [r for r in res if "devices" in r]
    for r in per_mesh:
        assert r["ranks_share_device"] == (r["devices"] > 1)
        assert r["backend"] == "gloo"
        assert r["bytes_staged_per_scan_per_rank"] == 0.0  # CPU tensors
    rates = [r for r in per_mesh if r["metric"] == "sharded_pf_scans_per_sec"]
    assert [(r["devices"], r["particles"], r["scans"]) for r in rates] == [
        (1, 8, 32), (2, 16, 32)]
    assert all(r["value"] > 0 and r["resamples"] >= 1 for r in rates)
    assert res[-1]["ranks_share_device"] is True
    hist = [r for r in per_mesh
            if r["metric"] == "ancestor_ring_distance_histogram"]
    assert [len(h["histogram"]) for h in hist] == [1, 2]


def _one_rank_run(mesh, cfg, pf, log):
    return run_sharded_fastslam(log, cfg, pf, seed=0, mesh=mesh)[1]


def test_one_rank_trajectory_is_run_sharded_fastslams():
    torch.set_num_threads(2)
    args = SimpleNamespace(device="cpu", grid=64, scans=32,
                           particles_per_rank=8)
    cfg = bst.config(args.grid)
    log = bst.scaling_log(cfg, args.scans)
    m = bst.measure(1, args, cfg, log)
    assert m["backend"] == "gloo" and not m["ranks_share_device"]
    (ref,) = pmesh.spawn(_one_rank_run, 1, "gloo", "cpu",
                         args=(cfg, PFConfig(n_particles=8), log))
    np.testing.assert_array_equal(m["traj"], ref)


def test_placement_and_a_backend_the_machine_cannot_give():
    assert bst.placement(1, "cpu") == ("gloo", "cpu", False)
    assert bst.placement(4, "cpu") == ("gloo", "cpu", True)
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            bst.placement(1, "cuda")
