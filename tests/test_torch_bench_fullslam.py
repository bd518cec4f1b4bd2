"""scripts/bench_fullslam_torch.py, the PyTorch port's twin of
scripts/bench_fullslam.py: its configs are the configs the script builds
from its literal arguments, field for field; its log is the script's
simulate_log over the script's waypoints, array for array; and its CPU
test mode prints one JSON line a variant with the script's keys (and
`device`) without importing JAX or the JAX package."""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np

from slam2d_tpu.config import (
    FrontendConfig,
    GraphConfig,
    GridConfig,
    MatcherConfig,
    SensorConfig,
)
from slam2d_tpu.data.synth import SynthWorld, simulate_log
from slam2d_tpu.grid.tiles import TileConfig
from slam2d_tpu_torch.run import bench_configs
from torch_parity import to_port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# scripts/bench_fullslam.py's keys, and the card's name and power limit
KEYS = {"variant", "scans", "scans_per_sec", "wall_s", "n_loops",
        "loop_attempts", "kf_ate_m", "session_calibration", "device"}


def _script_configs():
    """scripts/bench_fullslam.py:41-54, its literal arguments."""
    sensor = SensorConfig(n_beams=180, max_range=12.0)
    cfg = FrontendConfig(
        sensor=sensor,
        grid=GridConfig(resolution=0.1, ray_samples=128),
        matcher=MatcherConfig(search_xy=0.3, search_theta=0.15, n_theta=13),
        chunk=32,
        bootstrap_dist=2.0,
    )
    tcfg = TileConfig(tile=256, n_slots=48, resolution=0.1)
    gcfg = GraphConfig(
        max_nodes=512, max_edges=2048, keyframe_dist=1.0,
        loop_min_gap=20, loop_radius=3.0, loop_score_accept=0.35,
        loop_max_correction_xy=2.5, gn_iters=10,
    )
    return cfg, tcfg, gcfg


def test_config_is_the_scripts():
    cfg, tcfg, gcfg = bench_configs.fullslam_script_config()
    jcfg, jtcfg, jgcfg = _script_configs()
    assert cfg == to_port(jcfg)
    assert gcfg == to_port(jgcfg)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jtcfg)
    # the killian config with the script's long-drift correction bound
    k_cfg, k_tcfg, k_gcfg = bench_configs.fullslam_tiled_killian_config()
    assert (cfg, tcfg) == (k_cfg, k_tcfg)
    assert gcfg == dataclasses.replace(k_gcfg, loop_max_correction_xy=2.5)
    assert cfg.grid.update_impl == "auto"


def test_log_is_the_scripts():
    """scripts/bench_fullslam.py:55-62: two laps of the box-rooms tour."""
    jcfg = _script_configs()[0]
    lap = [[3.0, 3.0], [3.0, 8.0], [8.0, 8.0], [12.0, 3.5], [16.0, 3.5],
           [17.0, 9.0], [12.0, 14.0], [9.0, 17.0], [4.0, 16.0], [3.0, 10.0]]
    wp = np.array(lap + [[3.0, 3.5]] + lap[1:] + [[3.0, 4.0]])
    want = simulate_log(SynthWorld.box_rooms(20.0), wp, jcfg.sensor,
                        step=0.15, odom_noise_xy=0.02,
                        odom_noise_theta=0.006, seed=3)
    got = bench_configs.fullslam_bench_log(
        bench_configs.fullslam_script_config()[0].sensor, 3)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]),
                                      np.asarray(want[k]), err_msg=k)
    assert len(got["odom"]) == 715


def test_cpu_mode_prints_the_scripts_lines():
    code = textwrap.dedent(
        """
        import runpy, sys
        import torch
        torch.set_num_threads(2)
        sys.argv = ["bench_fullslam_torch.py", "--device", "cpu",
                    "--scans", "64", "--variant", "both"]
        runpy.run_path("scripts/bench_fullslam_torch.py", run_name="__main__")
        print(sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "slam2d_tpu")))
        """
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=600, cwd=ROOT,
    )
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert lines[-1] == "[]"
    rows = [json.loads(x) for x in lines[:-1]]
    assert [r["variant"] for r in rows] == ["incremental", "full_rebuild"]
    for r in rows:
        assert set(r) == KEYS
        assert r["scans"] == 64 and r["scans_per_sec"] > 0
        assert r["wall_s"] > 0 and r["n_loops"] >= 0
        assert 0 <= r["kf_ate_m"] < 0.5
        assert r["device"] == {"name": "cpu", "power_limit": None}
    # the two variants differ only after an accepted loop
    assert rows[0]["kf_ate_m"] == rows[1]["kf_ate_m"]


def test_no_card_raises():
    """--device cuda with no card raises; it does not run on the CPU."""
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import bench_fullslam_torch

    if bench_fullslam_torch.torch.cuda.is_available():
        return
    out = subprocess.run(
        [sys.executable, "scripts/bench_fullslam_torch.py", "--scans", "8"],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
    )
    assert out.returncode != 0 and not out.stdout.strip()
    assert "no CUDA device" in out.stderr
