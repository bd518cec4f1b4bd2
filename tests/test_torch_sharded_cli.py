"""PyTorch port: the CLI's --shard and --optimizer schur_sharded on
worlds of 2 and 4 gloo ranks on the CPU (run/cli.py's rank body, spawned
from the test as torchrun or the CLI's own spawn would start it; rank
bodies in tests/torch_dist.py), against the JAX CLI's runs of the same
arguments (tests/test_torch_cli.py's config):

- full SLAM with "schur_sharded": the same keys, the same keyframe and
  loop counts, the trajectory within 5e-3 (the CLI parity's tolerance);
- FastSLAM-8 with --shard: the same keys, JAX's CLI bounds (N_eff in
  [1, P], finite ATE), and at 4 ranks (2 particles a rank, every mode
  resolving per particle) the trajectory within 1e-5 of the one rank's
  and the same mean N_eff to 1e-3, as tests/test_torch_sharded_run.py
  holds 2 ranks.

Only rank 0 writes the outputs and prints: one JSON line, its metrics.
"""

import json

import numpy as np
import pytest
import torch

import torch_dist
from slam2d_tpu_torch.parallel import mesh as pmesh
from test_torch_cli import SMALL, _close, _jax, _port, _same_keys, _traj
from test_torch_sharded_run import PF_ARGV

torch.set_num_threads(1)

FULL_ARGV = [*SMALL, "--mode", "full", "--optimizer", "schur_sharded"]


def _ranks(n, argv, out, capfd):
    """The CLI on n gloo ranks: its metrics (rank 0's file) and the JSON
    lines printed."""
    res = pmesh.spawn(torch_dist.cli_rank, n, "gloo", "cpu", args=(
        ["--device", "cpu", *argv, "--out", str(out)],))
    assert res == [0] * n
    lines = [x for x in capfd.readouterr().out.strip().splitlines()
             if x.startswith("{")]
    return json.loads((out / "metrics.json").read_text()), lines


@pytest.mark.parametrize("n", [2, 4])
def test_cli_schur_sharded_on_ranks_matches_jax(tmp_path, capfd, n):
    mj = _jax([*FULL_ARGV, "--out", str(tmp_path / "j")], capfd)
    m, lines = _ranks(n, FULL_ARGV, tmp_path / "p", capfd)
    assert len(lines) == 1 and json.loads(lines[0]) == m
    _same_keys(m, mj)
    assert (m["n_keyframes"], m["n_loops"]) == (mj["n_keyframes"],
                                                mj["n_loops"])
    assert m["n_loops"] >= 1
    _close(_traj(tmp_path / "p"), _traj(tmp_path / "j"))


def test_cli_shard_on_four_ranks_within_jax_bounds(tmp_path, capfd):
    mj = _jax(PF_ARGV, capfd)
    one = _port([*PF_ARGV, "--out", str(tmp_path / "one")], capfd)
    m, lines = _ranks(4, PF_ARGV, tmp_path / "four", capfd)
    assert len(lines) == 1 and json.loads(lines[0]) == m
    _same_keys(m, mj)
    assert m["scans"] == 192
    assert 1.0 <= m["mean_n_eff"] <= 8.01 and np.isfinite(m["ate_m"])
    assert abs(m["mean_n_eff"] - one["mean_n_eff"]) <= 1e-3
    np.testing.assert_allclose(_traj(tmp_path / "four"),
                               _traj(tmp_path / "one"), atol=1e-5)
