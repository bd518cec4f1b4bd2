"""PyTorch port: the multi-device layer (slam2d_tpu_torch/parallel/mesh.py)
on worlds of 2 and 4 gloo ranks on the CPU, spawned from the test (rank
bodies in tests/torch_dist.py). Every collective is held to numpy on
rows drawn from a seed: all_gather, the gathers exact, the sums to
float32 rounding (rtol 1e-6), the ring shifts and the broadcast exact.
CPU operands are never staged (staged_bytes 0). A rank's exception ends
the run and is raised in the caller. parallel/dryrun.py's
dryrun_multichip(2) (one sharded FastSLAM step, the Schur and CG solves
with their work split, the split tiled frontend) prints its tail line;
its command line runs on the cards unless told otherwise (here, with no
card, it raises), nccl when every rank has a card, gloo on the CPU or on
a shared card.
"""

import numpy as np
import pytest
import torch

import torch_dist
from slam2d_tpu_torch.parallel import dryrun
from slam2d_tpu_torch.parallel import mesh as pmesh

torch.set_num_threads(1)


@pytest.fixture(scope="module", params=[2, 4])
def world(request):
    n = request.param
    x = np.random.default_rng(n).normal(size=(n, 6)).astype(np.float32)
    return n, x, pmesh.spawn(torch_dist.collectives, n, "gloo", "cpu",
                             args=(x,))


def test_all_gather_matches_numpy(world):
    n, x, res = world
    for r in res:
        np.testing.assert_array_equal(r["stacked"], x)
        np.testing.assert_array_equal(r["tiled"], x)


def test_psum_and_pmax_match_numpy(world):
    n, x, res = world
    for r in res:
        np.testing.assert_allclose(r["psum"], x.sum(0), rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(r["pmax"], x.max(0))
        assert r["int_pmax"].tolist() == [max(k * 3 % n for k in range(n))]
    # every rank holds the same bits
    for r in res[1:]:
        np.testing.assert_array_equal(r["psum"], res[0]["psum"])


def test_ppermute_is_the_ring_shift(world):
    n, x, res = world
    for rank, r in enumerate(res):
        np.testing.assert_array_equal(r["ring"], x[(rank - 1) % n])
        np.testing.assert_array_equal(r["ring_out"], x[(rank - 1) % n])
        np.testing.assert_array_equal(r["ring2"], x[(rank - 2) % n])
        np.testing.assert_array_equal(r["ring_back"], x[(rank + 1) % n])


def test_broadcast_and_gather_to(world):
    n, x, res = world
    for rank, r in enumerate(res):
        np.testing.assert_array_equal(r["bcast"], x[n - 1])
        if rank == 0:
            np.testing.assert_array_equal(r["gathered"], x)
        else:
            assert r["gathered"] is None


def test_cpu_operands_are_not_staged(world):
    _, _, res = world
    assert all(r["staged"] == 0 for r in res)


def test_a_rank_exception_is_raised_in_the_caller():
    with pytest.raises(Exception, match="fails on purpose|rank|closed"):
        pmesh.spawn(torch_dist.raise_on_rank, 2, "gloo", "cpu", args=(1,),
                    timeout_s=60)


def test_world_of_one_runs_in_process():
    x = np.arange(12, dtype=np.float32).reshape(1, 12)
    (r,) = pmesh.spawn(torch_dist.collectives, 1, "gloo", "cpu", args=(x,))
    for k in ("psum", "pmax", "ring", "ring2", "bcast"):
        np.testing.assert_array_equal(r[k], x[0])
    np.testing.assert_array_equal(r["stacked"], x)
    with pytest.raises(RuntimeError, match="no mesh"):
        pmesh.current()


def test_nccl_takes_cuda_tensors_only():
    with pytest.raises(ValueError, match="nccl"):
        pmesh.join("nccl", 1, 0, "file:///nonexistent", device="cpu")
    with pytest.raises(ValueError, match="backend"):
        pmesh.join("mpi", 1, 0, "file:///nonexistent", device="cpu")


def test_dryrun_multichip_two_ranks(capfd):
    res = dryrun.dryrun_multichip(2, "gloo", "cpu")
    line = res[0]["line"]
    assert line.startswith("dryrun_multichip(2): ok")
    assert line in capfd.readouterr().out
    for r in res:
        assert np.isfinite(r["tiled_traj"]).all()
        np.testing.assert_array_equal(r["schur_poses"], res[0]["schur_poses"])
    # the loop is consistent: Schur and CG agree with the chain's poses
    assert np.abs(res[0]["schur_poses"][:, 0] - np.arange(8)).max() < 1e-3
    assert np.abs(res[0]["cg_poses"][:, 0] - np.arange(8)).max() < 1e-3


def test_dryrun_command_line_runs_on_the_cards(capfd, monkeypatch):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.main([])
    res = dryrun.main(["2", "--device", "cpu"])
    assert res[0]["line"] in capfd.readouterr().out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for cards, world, device, backend in (
        (4, 4, None, "nccl"), (4, 2, None, "nccl"), (1, 4, None, "gloo"),
        (1, 1, None, "nccl"), (4, 1, "cuda:0", "nccl"),
        (4, 2, "cuda:0", "gloo"), (4, 4, "cpu", "gloo"),
    ):
        monkeypatch.setattr(torch.cuda, "device_count", lambda c=cards: c)
        assert dryrun.default_backend(world, device) == backend
