"""bench_pf_torch.py, the PyTorch port's twin of bench_pf.py, in its CPU
test mode: a few dozen scans of bench_pf's log print one JSON line with
every key of the card's run, neither JAX nor the JAX package is imported,
and the flags whose settings the port does not carry raise, naming
ROADMAP.md. The rates it prints here are CPU numbers (its `device` says
so)."""

import json
import os
import subprocess
import sys
import textwrap

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import bench_pf_torch  # noqa: E402

KEYS = {
    "metric", "value", "unit", "vs_baseline", "ate_m", "ate_odom_m",
    "session_calibration", "device", "host_gated", "host_reads_per_scan",
    "capture_s", "runs", "scans", "repeats",
}


def test_bench_pf_torch_cpu_mode_prints_the_json_line():
    code = textwrap.dedent(
        """
        import runpy, sys
        import torch
        torch.set_num_threads(1)
        sys.argv = ["bench_pf_torch.py", "--device", "cpu", "--scans", "64",
                    "--repeats", "1", "--particles", "4"]
        runpy.run_path("bench_pf_torch.py", run_name="__main__")
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
    assert res["metric"] == "fastslam4_scans_per_sec"
    assert res["unit"] == "scans/s" and res["scans"] == 64
    assert res["value"] > 0 and res["runs"] == [res["value"]]
    assert res["vs_baseline"] == res["value"] / 1.0
    # 4 particles resolve to the device-gated steps, which read nothing
    assert res["host_gated"] is False and res["host_reads_per_scan"] == 0.0
    assert 0 <= res["ate_m"] < 0.5 and 0 <= res["ate_odom_m"] < 0.5
    # a CPU run names its device and writes no device number
    assert res["device"] == {"name": "cpu", "power_limit": None}
    assert res["capture_s"] is None
    assert res["session_calibration"]["matmul_1024_bf16_us"] is None


@pytest.mark.parametrize("flags", [
    ["--refine-chunk", "8"], ["--fuse-light-prefix", "0"],
    ["--update-bilinear"], ["--snapped-endpoints"], ["--unfused-endpoints"],
    ["--update-subcell", "2"], ["--carve-shrink", "0.5"],
    ["--anchor-dither", "random"],
])
def test_settings_the_port_does_not_carry_raise(flags):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        bench_pf_torch.configs(
            bench_pf_torch.build_parser().parse_args(flags))


def test_flags_reach_the_configs_as_bench_pf_passes_them():
    cfg, pf = bench_pf_torch.configs(bench_pf_torch.build_parser().parse_args(
        ["--particles", "16", "--resolution", "0.05", "--grid", "1024",
         "--update-impl", "pallas_ray", "--match-min-motion", "0.25",
         "--noise-xy", "0.02", "--images-f32", "--update-theta-slots", "32"]))
    assert (pf.n_particles, pf.noise_xy, pf.noise_theta) == (16, 0.02, 0.005)
    assert pf.update_images_f32 and pf.update_theta_slots == 32
    assert pf.map_dtype == "bfloat16" and pf.refine_chunk == 0
    assert (cfg.grid.height, cfg.grid.resolution) == (1024, 0.05)
    assert cfg.grid.ray_samples == 256 and cfg.grid.update_impl == "pallas_ray"
    assert cfg.match_min_motion == 0.25 and cfg.chunk == 32
    assert cfg.bootstrap_dist == 2.0 and cfg.matcher.n_theta == 9
