"""PyTorch port: the tile pool (slam2d_tpu_torch/grid/tiles.py) against
the JAX package's slam2d_tpu/grid/tiles.py (CPU).

Everything here is exact: the global cell of a world point (the JAX
function jitted, as the frontend runs it: XLA divides by the resolution as
a multiplication by its float32 reciprocal), slot lookups, activation,
`stitch_tiles`, and `gather_region` / `scatter_region` bit for bit on
tiles[:-1]. The trash slot (the last) is left out of the comparison: its
content is unspecified in both packages. Measured: 0 cells differ in
every case.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam2d_tpu.grid import tiles as jt
from slam2d_tpu_torch.grid import tiles as tt

torch.set_num_threads(1)

CPU = torch.device("cpu")
JCFG = jt.TileConfig(tile=64, n_slots=12, resolution=0.1)
TCFG = tt.TileConfig(tile=64, n_slots=12, resolution=0.1)
# (origin_rc, size, active tiles): windows over 1, 2 and 3 tiles a side,
# at negative tile indices, and over tiles that are not active
ALL9 = [(r, c) for r in (-1, 0, 1) for c in (0, 1, 2)]
REGIONS = {
    "1 tile": ((5, 7), 40, [(0, 0), (0, 1)]),
    "2x2 tiles": ((40, 30), 60, [(0, 0), (0, 1), (1, 0), (1, 1)]),
    "3x3 tiles, negative rows": ((-60, 10), 140, ALL9),
    "2x3 tiles, negative": ((-100, -70), 100,
                            [(-2, -2), (-2, -1), (-2, 0), (-1, -2), (-1, -1),
                             (-1, 0)]),
    "missing tiles": ((40, 30), 60, [(0, 0), (1, 1)]),
    "3x3, missing centre": ((-60, 10), 140,
                            [rc for rc in ALL9 if rc != (0, 1)]),
    "none active": ((1000, -1000), 70, [(0, 0)]),
}


def test_tile_config_copy_matches():
    assert [f.name for f in tt.dataclasses.fields(tt.TileConfig)] == [
        f.name for f in jt.dataclasses.fields(jt.TileConfig)]
    assert tt.TileConfig() == tt.TileConfig(**jt.dataclasses.asdict(
        jt.TileConfig()))
    assert tt.FREE_SLOT == jt.FREE_SLOT


def test_world_to_cell_global_rounds_as_jitted_jax():
    # fl32(1.3) / fl32(0.1) floors to 12, times fl32(1 / 0.1) = 10 to 13
    x = np.float32(1.3)
    assert np.floor(x / np.float32(0.1)) == 12
    assert np.floor(x * np.float32(10.0)) == 13
    rng = np.random.default_rng(0)
    xy = np.concatenate([
        np.array([[x, x], [0.05, -0.05], [-x, 2 * x], [0.0, -0.0]],
                 np.float32),
        rng.uniform(-50, 50, (64, 2)).astype(np.float32),
    ])
    for cfg_kw in (dict(resolution=0.1),
                   dict(origin_x=-3.3, origin_y=7.1, resolution=0.05)):
        jc = jt.TileConfig(tile=64, **cfg_kw)
        ref = np.asarray(jax.jit(
            lambda p: jt.world_to_cell_global(p, jc))(jnp.asarray(xy)))
        out = tt.world_to_cell_global(torch.from_numpy(xy),
                                      tt.TileConfig(tile=64, **cfg_kw))
        assert out.dtype == torch.int32
        np.testing.assert_array_equal(out.numpy(), ref)
        if len(cfg_kw) == 1:
            assert tuple(ref[0]) == (13, 13)


def _pools(active, seed=0):
    """The same pool in both packages: `active` tiles activated in order,
    every slot (the trash slot too) filled with seeded noise."""
    jtable, ttable = jt.TileTable(JCFG), tt.TileTable(TCFG)
    jg = jtable.activate(jt.tiled_init(JCFG), active)
    tg = ttable.activate(tt.tiled_init(TCFG, CPU), active)
    assert jtable.slot_of == ttable.slot_of
    np.testing.assert_array_equal(tg.coords.numpy(), np.asarray(jg.coords))
    noise = np.random.default_rng(seed).normal(
        0.0, 3.0, tg.tiles.shape).astype(np.float32)
    jg = jg._replace(tiles=jnp.asarray(noise))
    tg = tg._replace(tiles=torch.from_numpy(noise.copy()))
    return jg, tg, ttable


def test_activation_and_lookup_match_jax():
    xy = np.array([[0.1, 0.1], [9.0, -4.0]])
    need = jt.required_tiles(xy, 3.0, JCFG)
    assert need == tt.required_tiles(xy, 3.0, TCFG) and len(need) == 7
    # 6.4 m tiles, reach 7 m => a 4 x 4 neighbourhood around tile (0, 0)
    wide = tt.required_tiles(xy[:1], 7.0, TCFG)
    assert wide == jt.required_tiles(xy[:1], 7.0, JCFG) and len(wide) == 16
    jtable, ttable = jt.TileTable(JCFG), tt.TileTable(TCFG)
    first = sorted(need)[:5]
    jg = jtable.activate(jt.tiled_init(JCFG), first)
    tg = ttable.activate(tt.tiled_init(TCFG, CPU), first)
    # the second activation keeps the first's slots and adds the rest
    jg = jtable.activate(jg, need - set(first[:2]))
    tg = ttable.activate(tg, need - set(first[:2]))
    assert ttable.slot_of == jtable.slot_of and len(ttable.slot_of) == 7
    np.testing.assert_array_equal(tg.coords.numpy(), np.asarray(jg.coords))
    np.testing.assert_array_equal(tg.coords.numpy(), ttable.coords)
    for rc in [first[0], sorted(need)[-1], (5, 5), (-9, 0)]:
        js, jf = jt.lookup_slot(jg.coords, jnp.asarray(rc, jnp.int32))
        ts, tf = tt.lookup_slot(tg.coords, torch.tensor(rc, dtype=torch.int32))
        assert (int(ts), bool(tf)) == (int(js), bool(jf))
        assert ttable.slot(rc) == (int(ts) if bool(tf) else None)
    # a table rebuilt from the coords is the same table
    again = tt.TileTable.from_coords(TCFG, tg.coords)
    assert again.slot_of == ttable.slot_of
    np.testing.assert_array_equal(again.coords, ttable.coords)


def test_pool_exhausted_raises_like_jax():
    need = [(0, c) for c in range(13)]
    with pytest.raises(RuntimeError, match="pool exhausted"):
        jt.TileTable(JCFG).activate(jt.tiled_init(JCFG), need)
    table = tt.TileTable(TCFG)
    with pytest.raises(RuntimeError, match="pool exhausted"):
        table.activate(tt.tiled_init(TCFG, CPU), need)


@pytest.mark.parametrize("case", sorted(REGIONS))
def test_gather_region_bit_exact(case):
    origin, size, active = REGIONS[case]
    jg, tg, table = _pools(active)
    ref = np.asarray(jt.gather_region(jg, JCFG, jnp.asarray(origin, jnp.int32),
                                      size))
    out = tt.gather_region(tg, TCFG, origin, size, table)
    assert out.shape == (size, size)
    np.testing.assert_array_equal(out.numpy(), ref)
    # with a table rebuilt from the device coords: the same window
    np.testing.assert_array_equal(tt.gather_region(
        tg, TCFG, origin, size, tt.TileTable.from_coords(TCFG, tg.coords)
    ).numpy(), ref)
    # missing tiles read 0, never the trash slot's noise
    pieces = tt.region_pieces(origin, (size, size), TCFG.tile)
    for rc, wr, wc, _, _ in pieces:
        if table.slot(rc) is None:
            assert not out[wr, wc].any()


@pytest.mark.parametrize("case", sorted(REGIONS))
def test_scatter_region_bit_exact(case):
    origin, size, active = REGIONS[case]
    jg, tg, table = _pools(active)
    win = np.random.default_rng(1).normal(0.0, 2.0, (size, size)).astype(
        np.float32)
    ref = jt.scatter_region(jg, JCFG, jnp.asarray(win),
                            jnp.asarray(origin, jnp.int32))
    before = tg.tiles.clone()
    out = tt.scatter_region(tg, TCFG, torch.from_numpy(win), origin, table)
    assert out.tiles.data_ptr() == tg.tiles.data_ptr()   # in place
    np.testing.assert_array_equal(out.tiles[:-1].numpy(),
                                  np.asarray(ref.tiles)[:-1])
    np.testing.assert_array_equal(out.coords.numpy(), np.asarray(ref.coords))
    # the pieces of active tiles read back as the window within an ulp
    # (t + (w - t), as the JAX package writes it); nothing else moved
    back = tt.gather_region(out, TCFG, origin, size, table).numpy()
    mask = np.zeros((size, size), bool)
    for rc, wr, wc, _, _ in tt.region_pieces(origin, (size, size), TCFG.tile):
        mask[wr, wc] = table.slot(rc) is not None
    np.testing.assert_allclose(back[mask], win[mask], rtol=0, atol=5e-7)
    assert not back[~mask].any()
    touched = {table.slot(rc) for rc, *_ in tt.region_pieces(
        origin, (size, size), TCFG.tile)}
    for k in range(TCFG.n_slots):
        if k not in touched:
            assert torch.equal(out.tiles[k], before[k])


def test_stitch_tiles_matches_jax():
    jg, tg, _ = _pools([(0, 0), (1, 1), (-1, 2)])
    ref, ref_origin = jt.stitch_tiles(jg, JCFG)
    out, origin = tt.stitch_tiles(tg, TCFG)
    np.testing.assert_array_equal(out, ref)
    assert origin == ref_origin
    empty, o = tt.stitch_tiles(tt.tiled_init(TCFG, CPU), TCFG)
    assert empty.shape == (64, 64) and not empty.any() and o == (0.0, 0.0)


def _t_origin(origin):
    return torch.tensor(origin, dtype=torch.int32)


@pytest.mark.parametrize("case", sorted(REGIONS))
def test_gather_region_t_matches_the_host_form_and_jax(case):
    """The device-origin gather (slots from the device coords) equals the
    host-origin gather and JAX's gather_region bit for bit."""
    origin, size, active = REGIONS[case]
    jg, tg, table = _pools(active)
    ref = np.asarray(jt.gather_region(jg, JCFG, jnp.asarray(origin, jnp.int32),
                                      size))
    out = tt.gather_region_t(tg, TCFG, _t_origin(origin), size)
    assert out.shape == (size, size) and out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy(), ref)
    assert torch.equal(out, tt.gather_region(tg, TCFG, origin, size, table))


@pytest.mark.parametrize("case", sorted(REGIONS))
def test_scatter_region_t_matches_the_host_form_and_jax(case):
    """The device-origin scatter writes the host form's bits (t + (w - t)
    into active tiles) and JAX's on tiles[:-1]; with gate 1 the same."""
    origin, size, active = REGIONS[case]
    jg, tg, table = _pools(active)
    win = np.random.default_rng(1).normal(0.0, 2.0, (size, size)).astype(
        np.float32)
    ref = jt.scatter_region(jg, JCFG, jnp.asarray(win),
                            jnp.asarray(origin, jnp.int32))
    host = tt.scatter_region(tt.TiledGrid(tg.tiles.clone(), tg.coords), TCFG,
                             torch.from_numpy(win), origin, table)
    for gate in (None, torch.tensor(True)):
        pool = tt.TiledGrid(tg.tiles.clone(), tg.coords)
        out = tt.scatter_region_t(pool, TCFG, torch.from_numpy(win),
                                  _t_origin(origin), gate=gate)
        assert out.tiles.data_ptr() == pool.tiles.data_ptr()   # in place
        np.testing.assert_array_equal(out.tiles[:-1].numpy(),
                                      np.asarray(ref.tiles)[:-1])
        assert torch.equal(out.tiles[:-1], host.tiles[:-1])


@pytest.mark.parametrize("case", sorted(REGIONS))
def test_scatter_region_t_gate_off_keeps_every_bit(case):
    """A gated-off scatter leaves every active tile bit-identical, -0.0
    cells included (t + (t - t) would turn them into +0.0), and the
    gathered window unchanged."""
    origin, size, active = REGIONS[case]
    _, tg, _ = _pools(active)
    tiles = tg.tiles.clone()
    neg = np.random.default_rng(2).random(tiles.shape) < 0.3
    tiles[torch.from_numpy(neg)] = -0.0
    pool = tt.TiledGrid(tiles.clone(), tg.coords)
    before = tt.gather_region_t(pool, TCFG, _t_origin(origin), size)
    tt.scatter_region_t(pool, TCFG, before, _t_origin(origin),
                        gate=torch.tensor(False))
    assert torch.equal(pool.tiles[:-1].view(torch.int32),
                       tiles[:-1].view(torch.int32))
    # gate 1 writes the window back: t + (t - t) turns -0.0 into +0.0
    tt.scatter_region_t(pool, TCFG, before, _t_origin(origin),
                        gate=torch.tensor(True))
    moved = pool.tiles[:-1].view(torch.int32) != tiles[:-1].view(torch.int32)
    assert torch.equal(pool.tiles[:-1], tiles[:-1])
    if case != "none active":
        assert moved.any()


@pytest.mark.parametrize("case", sorted(REGIONS))
def test_region_t_ops_follow_relabelled_slots(case):
    """With the pool's slots permuted (tiles and coords together, as a
    table rebuilt in another order would hold them) the device-origin
    gather reads the same window and the scatter writes the same tiles:
    the slots come from the coords, not from their order."""
    origin, size, active = REGIONS[case]
    _, tg, _ = _pools(active)
    n = TCFG.n_slots
    perm = torch.cat([torch.from_numpy(np.random.default_rng(3).permutation(n)),
                      torch.tensor([n])])
    moved = tt.TiledGrid(tg.tiles[perm].clone(), tg.coords[perm].clone())
    np.testing.assert_array_equal(
        tt.gather_region_t(moved, TCFG, _t_origin(origin), size).numpy(),
        tt.gather_region_t(tg, TCFG, _t_origin(origin), size).numpy())
    win = torch.from_numpy(np.random.default_rng(1).normal(
        0.0, 2.0, (size, size)).astype(np.float32))
    tt.scatter_region_t(tg, TCFG, win, _t_origin(origin))
    tt.scatter_region_t(moved, TCFG, win, _t_origin(origin))
    assert torch.equal(moved.tiles[perm[:-1].argsort()], tg.tiles[:-1])


def test_activate_writes_the_coords_in_place():
    """Activation copies the host table into the device coords tensor the
    grid holds (a captured CUDA graph reads that buffer)."""
    grid = tt.tiled_init(TCFG, CPU)
    ptr = grid.coords.data_ptr()
    table = tt.TileTable(TCFG)
    out = table.activate(grid, [(0, 0), (-1, 2)])
    assert out.coords is grid.coords and grid.coords.data_ptr() == ptr
    np.testing.assert_array_equal(grid.coords.numpy(), table.coords)
    table.activate(grid, [(0, 0), (3, 3)])
    assert grid.coords.data_ptr() == ptr
    assert table.slot((3, 3)) == 2
    np.testing.assert_array_equal(grid.coords.numpy(), table.coords)
