"""scripts/bench_ate_torch.py, the PyTorch port's twin of
scripts/bench_ate.py, in its CPU test mode: a short run of the bench log
prints one JSON line with bench_ate.py's keys (its `backend` the CPU's),
neither JAX nor the JAX package is imported, its config is bench_ate.py's,
and the scorers the port does not carry raise."""

import json
import os
import subprocess
import sys
import textwrap

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import bench_ate_torch  # noqa: E402

# scripts/bench_ate.py's keys, and the port's power limit and scan count
KEYS = {"impl", "seed", "fine_theta_bins", "backend", "scans_per_sec",
        "ate_slam_m", "ate_odom_m", "power_limit", "scans"}


def test_bench_ate_torch_cpu_mode_prints_the_json_line():
    code = textwrap.dedent(
        """
        import runpy, sys
        import torch
        torch.set_num_threads(2)
        sys.argv = ["bench_ate_torch.py", "pallas_hybrid", "1", "2", "auto",
                    "--device", "cpu", "--scans", "64"]
        runpy.run_path("scripts/bench_ate_torch.py", run_name="__main__")
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
    res = json.loads(lines[-2])
    assert set(res) == KEYS
    assert (res["impl"], res["seed"], res["fine_theta_bins"]) == (
        "pallas_hybrid", 1, 2)
    assert res["backend"] == "cpu" and res["power_limit"] is None
    assert res["scans"] == 64 and res["scans_per_sec"] > 0
    assert 0 <= res["ate_slam_m"] < 0.5 and 0 < res["ate_odom_m"] < 0.5


def test_config_and_log_are_bench_ate_pys():
    cfg = bench_ate_torch.config("pallas_ray", 3, "cmx")
    g, m, s = cfg.grid, cfg.matcher, cfg.sensor
    assert (g.height, g.width, g.resolution, g.ray_samples) == (
        1024, 1024, 0.05, 256)
    assert (g.center_x, g.center_y, g.update_impl) == (10.0, 10.0,
                                                       "pallas_ray")
    assert (m.search_xy, m.search_theta, m.n_theta) == (0.3, 0.15, 13)
    assert (m.fine_theta_bins, m.score_impl) == (3, "cmx")
    assert (s.n_beams, s.max_range, cfg.chunk, cfg.match_min_motion) == (
        180, 12.0, 64, 0.25)
    log = bench_ate_torch.bench_ate_log(cfg, seed=2)
    assert len(log["odom"]) % 64 == 0 and len(log["odom"]) > 900


@pytest.mark.parametrize("score_impl", ["mxu", "mxu_int8"])
def test_tpu_scorers_raise(score_impl):
    with pytest.raises(NotImplementedError, match="not ported"):
        bench_ate_torch.config(score_impl=score_impl)
