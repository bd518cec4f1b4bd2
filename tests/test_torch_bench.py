"""bench_torch.py, the PyTorch port's twin of bench.py, in its CPU test
mode: a few dozen scans of the bench log print one JSON line with every
key of the card's run, and neither JAX nor the JAX package is imported.
The rates it prints here are CPU numbers (its `device` says so)."""

import json
import os
import subprocess
import sys
import textwrap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = {
    "metric", "value", "unit", "vs_baseline", "mode", "scans", "repeats",
    "scans_per_sec_runs", "cuda_event_scans_per_sec", "capture_s",
    "offline_scans_per_sec", "eager_scans_per_sec",
    "eager_scans_per_sec_runs", "reference_scans_per_sec",
    "host_reads_per_scan", "ate_m", "update_impl", "score_impl",
    "fine_theta_bins", "session_calibration", "device",
}


def test_bench_torch_cpu_mode_prints_the_json_line():
    code = textwrap.dedent(
        """
        import runpy, sys
        import torch
        torch.set_num_threads(1)
        sys.argv = ["bench_torch.py", "--device", "cpu", "--scans", "40",
                    "--repeats", "1"]
        runpy.run_path("bench_torch.py", run_name="__main__")
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
    assert res["metric"] == "frontend_scans_per_sec"
    assert res["unit"] == "scans/s" and res["scans"] == 40
    assert res["value"] > 0 and res["eager_scans_per_sec"] > 0
    assert res["offline_scans_per_sec"] > 0
    assert res["reference_scans_per_sec"] > 0
    assert res["vs_baseline"] == res["value"] / res["reference_scans_per_sec"]
    assert res["host_reads_per_scan"] == 0.0
    assert 0 <= res["ate_m"] < 0.1
    assert res["update_impl"] == "pallas_hybrid"
    assert res["score_impl"] == "gather"
    assert res["fine_theta_bins"] == 2
    # a CPU run names its device and writes no device number
    assert res["device"] == {"name": "cpu", "power_limit": None}
    assert res["mode"] == "eager_cpu" and res["capture_s"] is None
    assert res["session_calibration"]["matmul_1024_bf16_us"] is None


def test_bench_endurance_torch_cpu_mode():
    """scripts/bench_endurance_torch.py, the twin of
    scripts/bench_endurance.py, on the first chunk of its log on the CPU:
    its config is bench_endurance.py's, it prints its JSON line (no loop
    can close in one chunk, so the gate reports a failure and the script
    exits 1), and it imports neither JAX nor the JAX package."""
    code = textwrap.dedent(
        """
        import runpy, sys
        import torch
        torch.set_num_threads(1)
        sys.argv = ["bench_endurance_torch.py", "--device", "cpu",
                    "--scans", "64"]
        try:
            runpy.run_path("scripts/bench_endurance_torch.py",
                           run_name="__main__")
        except SystemExit as e:
            print("exit", e.code)
        print("jax" in sys.modules, "slam2d_tpu" in sys.modules)
        """
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=600, cwd=ROOT,
    )
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert lines[-1] == "False False" and lines[-2] == "exit 1"
    res = json.loads(lines[-3])
    assert res["scans"] == 64 and res["optimizer"] == "schur"
    assert res["value"] > 0 and res["traj_finite"]
    assert res["n_loops"] == 0 and not res["gate_pass"]
    assert res["gate"] == {"aligned_m": 0.8, "unaligned_m": 3.8,
                           "min_loops": 10}
    assert res["device"] == "cpu" and res["device_memory_peak_bytes"] is None
