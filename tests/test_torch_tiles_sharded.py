"""PyTorch port: the tile pool split over the ranks
(slam2d_tpu_torch/grid/tiles_sharded.py) on worlds of 2 and 4 gloo ranks
on the CPU, against the JAX package's grid/tiles_sharded.py on
make_particle_mesh(n) (the counterpart of tests/test_tiles_sharded.py).

Windows of 96^2 over tiles of 64^2 at origins inside, across negative
indices and over tiles that are not active: scattered, gathered back and
gathered one tile away, in sequence on one pool. Every gathered window
and the whole pool after the sequence are bit-exact against JAX's; the
first window on the fresh pool is bit-exact against the single-device
port's scatter and gather too; missing tiles read 0; the content lands
on more than one rank.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as PS

import torch_dist
from slam2d_tpu.grid import tiles as jtiles
from slam2d_tpu.grid.tiles_sharded import (
    gather_region_sharded,
    scatter_region_sharded,
)
from slam2d_tpu.parallel.mesh import make_particle_mesh
from slam2d_tpu_torch.grid import tiles as ttiles
from slam2d_tpu_torch.parallel import mesh as pmesh

torch.set_num_threads(1)

JCFG = jtiles.TileConfig(tile=64, n_slots=16, resolution=0.1)
TCFG = ttiles.TileConfig(tile=64, n_slots=16, resolution=0.1)
AXIS = "particles"
SIZE = 96
NEEDED = [(0, 0), (0, 1), (1, 0), (1, 1), (-1, 0), (-1, 1), (2, -1), (0, 2),
          (2, 1), (2, 0)]
ORIGINS = [(20, 30), (-40, 70), (100, -10), (-70, -60)]


def _cases():
    rng = np.random.default_rng(0)
    return [(rng.normal(size=(SIZE, SIZE)).astype(np.float32), o)
            for o in ORIGINS]


def _jax(n):
    """JAX's sequence on make_particle_mesh(n): each case's (back, far)
    windows and the final pool."""
    mesh = make_particle_mesh(n)
    g = jtiles.tiled_init(JCFG)
    g = jtiles.TileTable(JCFG).activate(g, NEEDED)
    coords = g.coords
    tiles = jnp.zeros((JCFG.n_slots, JCFG.tile, JCFG.tile), jnp.float32)

    def step(tiles_local, coords, win, origin, far):
        tl = scatter_region_sharded(tiles_local, coords, JCFG, win, origin,
                                    AXIS)
        back = gather_region_sharded(tl, coords, JCFG, origin, SIZE, AXIS)
        other = gather_region_sharded(tl, coords, JCFG, far, SIZE, AXIS)
        return tl, back, other

    f = jax.jit(jax.shard_map(
        step, mesh=mesh,
        in_specs=(PS(AXIS), PS(None), PS(None), PS(None), PS(None)),
        out_specs=(PS(AXIS), PS(None), PS(None)), check_vma=False,
    ))
    outs = []
    for win, o in _cases():
        far = (o[0] - JCFG.tile // 2, o[1] + JCFG.tile)
        tiles, back, other = f(tiles, coords, jnp.asarray(win),
                               jnp.asarray(o, jnp.int32),
                               jnp.asarray(far, jnp.int32))
        outs.append((np.asarray(back), np.asarray(other)))
    return outs, np.asarray(tiles), np.asarray(coords)


@pytest.fixture(scope="module", params=[2, 4])
def world(request):
    n = request.param
    res = pmesh.spawn(torch_dist.tile_ops, n, "gloo", "cpu",
                      args=(TCFG, NEEDED, _cases()))
    return n, res, _jax(n)


def test_region_ops_match_jax(world):
    _, res, (ref_outs, ref_pool, ref_coords) = world
    np.testing.assert_array_equal(res[0]["coords"], ref_coords)
    for r in res:
        for (back, other), (jb, jo) in zip(r["outs"], ref_outs):
            np.testing.assert_array_equal(back, jb)
            np.testing.assert_array_equal(other, jo)
    np.testing.assert_array_equal(res[0]["pool"], ref_pool)


def test_region_ops_match_single_device_port(world):
    _, res, _ = world
    win, origin = _cases()[0]
    table = ttiles.TileTable(TCFG)
    g = table.activate(ttiles.tiled_init(TCFG, "cpu"), NEEDED)
    ttiles.scatter_region(g, TCFG, torch.from_numpy(win), origin, table)
    back = ttiles.gather_region(g, TCFG, origin, SIZE, table)
    np.testing.assert_array_equal(res[0]["outs"][0][0], back.numpy())
    far = (origin[0] - TCFG.tile // 2, origin[1] + TCFG.tile)
    np.testing.assert_array_equal(
        res[0]["outs"][0][1],
        ttiles.gather_region(g, TCFG, far, SIZE, table).numpy())


def test_missing_tiles_read_zero_and_content_is_split(world):
    n, res, _ = world
    # origin (100, -10) overlaps tile (1, -1), which is not active
    back = res[0]["outs"][2][0]
    rows = slice(0, 2 * TCFG.tile - 100)
    assert (back[rows, :10] == 0).all()
    assert (back[rows, 10:] != 0).any()
    pool = res[0]["pool"]
    n_local = pool.shape[0] // n
    owners = {k // n_local for k in range(pool.shape[0])
              if np.abs(pool[k]).sum() > 0}
    assert len(owners) >= 2
    assert all(r["staged"] == 0 for r in res)
