"""PyTorch port: the multi-device entry points of the command line and
the checkpoints, on gloo ranks on the CPU (rank bodies in
tests/torch_dist.py):

- the CLI's --shard and --optimizer schur_sharded: in one process (one
  gloo rank, as `--device cpu` runs) against the JAX CLI's run (the same
  keys; FastSLAM, whose random streams differ, to the JAX CLI test's
  bounds; full SLAM with the same keyframe and loop counts, the
  trajectory within 5e-3); the rank body at 2 ranks equal to the one
  rank's run (FastSLAM-8's trajectory within 1e-5: every mode resolves
  per particle at both sizes), rank 0 alone writing outputs;
  --save-video with --shard exits as the JAX CLI does;
- a sharded run saved through utils/checkpoint (gathered to rank 0) and
  resumed (placed again) equals the unsplit run at 2 and 4 ranks
  (trajectory 1e-4, N_eff 1e-3: tests/test_resume.py's tolerances).
"""

import json
import os

import numpy as np
import pytest
import torch

import torch_dist
from slam2d_tpu_torch.parallel import mesh as pmesh
from slam2d_tpu_torch.run import cli as tcli
from test_torch_cli import SMALL, _close, _jax, _port, _same_keys, _traj

torch.set_num_threads(1)

PF_ARGV = [*SMALL, "--mode", "fastslam", "--particles", "8", "--shard",
           "--scan-range", "0", "192"]


def test_cli_shard_within_jax_bounds_and_across_ranks(tmp_path, capsys):
    one = _port([*PF_ARGV, "--out", str(tmp_path / "one")], capsys)
    mj = _jax(PF_ARGV, capsys)
    _same_keys(one, mj)
    assert one["scans"] == 192
    assert 1.0 <= one["mean_n_eff"] <= 8.01 and np.isfinite(one["ate_m"])
    two = pmesh.spawn(torch_dist.cli_rank, 2, "gloo", "cpu", args=(
        ["--device", "cpu", *PF_ARGV, "--out", str(tmp_path / "two")],))
    assert two == [0, 0]
    lines = capsys.readouterr().out.strip().splitlines()
    m2 = json.loads((tmp_path / "two" / "metrics.json").read_text())
    assert abs(m2["mean_n_eff"] - one["mean_n_eff"]) <= 1e-3
    np.testing.assert_allclose(_traj(tmp_path / "two"),
                               _traj(tmp_path / "one"), atol=1e-5)
    assert np.load(tmp_path / "two" / "map_logodds.npy").shape == (256, 256)
    assert len([x for x in lines if x.startswith("{")]) <= 1


def test_cli_schur_sharded_matches_jax(tmp_path, capsys):
    argv = [*SMALL, "--mode", "full", "--optimizer", "schur_sharded"]
    m = _port([*argv, "--out", str(tmp_path / "p")], capsys)
    mj = _jax([*argv, "--out", str(tmp_path / "j")], capsys)
    _same_keys(m, mj)
    assert (m["n_keyframes"], m["n_loops"]) == (mj["n_keyframes"],
                                                mj["n_loops"])
    assert m["n_loops"] >= 1
    _close(_traj(tmp_path / "p"), _traj(tmp_path / "j"))


def test_cli_shard_refuses_video():
    with pytest.raises(SystemExit, match="non-sharded"):
        tcli.main(["--device", "cpu", *PF_ARGV, "--save-video", "v.gif"])


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_resume_matches_unsplit_run(tmp_path, n):
    from test_torch_sharded_pf import TCFG, TPF, _log

    log = _log()
    T = len(log["odom"])
    cut = (T // 2 // TCFG.chunk) * TCFG.chunk
    rng = np.random.default_rng(4)
    draws = (rng.normal(size=(T, TPF.n_particles, 3)).astype(np.float32),
             rng.uniform(size=T).astype(np.float32))
    full = pmesh.spawn(torch_dist.pf_run, n, "gloo", "cpu",
                       args=(log, TCFG, TPF, 0, None, draws))[0]
    split = pmesh.spawn(torch_dist.pf_resume, n, "gloo", "cpu", args=(
        log, TCFG, TPF, draws, cut, str(tmp_path / "ck")))
    for r in split:
        np.testing.assert_allclose(r["traj"], full["traj"], atol=1e-4)
        np.testing.assert_allclose(r["n_eff"], full["n_eff"], atol=1e-3)
    assert os.path.exists(tmp_path / "ck")
