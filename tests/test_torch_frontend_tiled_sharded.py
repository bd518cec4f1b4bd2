"""PyTorch port: the tiled frontend on the tile pool split over the ranks
(slam2d_tpu_torch/run/frontend_tiled_sharded.py) on worlds of 2 and 4
gloo ranks on the CPU, against the JAX package's
run/frontend_tiled_sharded.py on make_tile_mesh(n) (the counterpart of
tests/test_tiled_frontend_sharded.py).

Config and log: tests/test_torch_frontend_tiled.py's (128^2 tiles at 0.1
m, the hybrid update, which JAX runs in interpret mode; a pool of 12
slots, so that the 9 tiles it activates spread over the ranks), its first 96
scans. Held as the single-device port's tiled frontend is held to JAX's:
per-scan |dxy| and |dtheta| <= 5e-3, the same scans matched, the same
slots active; against the single-device port's run, the same
trajectory and scores bit for bit (the window psum adds one owner's
value to zeros) and the tiles within 1e-6: the sharded scatter writes
the window's value w, as JAX's sharded scatter does, the single-device
one t + (w - t), as JAX's single-device one-hot form does, which moves
a cell by an ulp where the subtraction rounds (10 search-space cells of
147,456 here). Every rank returns the same trajectory; the map lands on
more than one rank.
"""

import functools

import numpy as np
import pytest
import torch

import torch_dist
from slam2d_tpu.run import frontend_tiled_sharded as jfts
from slam2d_tpu.grid import tiles as jtiles
from slam2d_tpu_torch.grid import tiles as ttiles
from slam2d_tpu_torch.parallel import mesh as pmesh
from slam2d_tpu_torch.run import frontend_tiled as tft
from torch_parity import pose_error, to_port
from test_torch_frontend_tiled import CFG, _log

torch.set_num_threads(1)

POSE_TOL = 5e-3
SCANS = 96          # six chunks of 16
JTCFG = jtiles.TileConfig(tile=128, n_slots=12, resolution=0.1)
TTCFG = ttiles.TileConfig(tile=128, n_slots=12, resolution=0.1)


@functools.cache
def _short_log():
    return {k: np.asarray(v)[:SCANS] for k, v in _log().items()}


@functools.cache
def _single_port():
    return tft.run_tiled_frontend(_short_log(), to_port(CFG), TTCFG,
                                  torch.device("cpu"))


@pytest.fixture(scope="module", params=[2, 4])
def world(request):
    n = request.param
    res = pmesh.spawn(torch_dist.tiled_run, n, "gloo", "cpu",
                      args=(_short_log(), to_port(CFG), TTCFG))
    _, traj, scores = jfts.run_sharded_tiled_frontend(
        _short_log(), CFG, JTCFG, mesh=jfts.make_tile_mesh(n))
    return n, res, (traj, scores)


def test_trajectory_matches_jax(world):
    _, res, (jt, jsc) = world
    tt, tsc = res[0]["traj"], res[0]["scores"]
    for r in res[1:]:
        np.testing.assert_array_equal(r["traj"], tt)
    assert tt.shape == jt.shape and np.isfinite(tt).all()
    dxy, dth = pose_error(tt, jt)
    print(f"sharded tiled: max |dxy| {dxy:.3g} m, max |dtheta| {dth:.3g}")
    assert dxy <= POSE_TOL and dth <= POSE_TOL
    np.testing.assert_array_equal(tsc == -1.0, jsc == -1.0)


def test_same_bits_as_single_device_port(world):
    n, res, _ = world
    state, traj, scores = _single_port()
    np.testing.assert_array_equal(res[0]["traj"], traj)
    np.testing.assert_array_equal(res[0]["scores"], scores)
    # the same tiles active in the same slots, the same content
    coords = state.grid.coords.numpy()
    act = np.flatnonzero(coords[:-1, 0] > ttiles.FREE_SLOT)
    np.testing.assert_array_equal(res[0]["coords"][act], coords[act])
    np.testing.assert_allclose(res[0]["tiles"][act],
                               state.grid.tiles.numpy()[act], atol=1e-6,
                               rtol=0)
    np.testing.assert_allclose(res[0]["stiles"][act],
                               state.sgrid.tiles.numpy()[act], atol=1e-6,
                               rtol=0)
    # the pool is padded to a multiple of the world size and split
    n_pad = -(-TTCFG.n_slots // n) * n
    assert res[0]["tiles"].shape[0] == n_pad
    assert sum(r["local_with_content"] > 0 for r in res) >= 2
