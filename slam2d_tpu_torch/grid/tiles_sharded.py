"""The tile pool with its slot axis split over the ranks of a mesh, port
of slam2d_tpu/grid/tiles_sharded.py.

Each rank holds n_slots / world_size tiles, slots [rank * n_local,
(rank + 1) * n_local); a slot's owner is slot // n_local. The slot table
stays on the host (grid/tiles.py's TileTable, every rank the same), and
a window's pieces come from grid/tiles.py's `region_pieces`.

- gather: each rank pastes the pieces of the tiles it owns into a zero
  window, and one psum of the window merges them; exact, since one owner
  adds its value and every other rank adds 0. Missing tiles read 0.
- scatter: the window is replicated; each rank writes only the pieces of
  tiles it owns, a plain copy (the JAX package's masked select writes
  the window's value), with no collective. A piece of a tile that is not
  active is dropped.
"""

from __future__ import annotations

import torch

from slam2d_tpu_torch.grid.tiles import TileConfig, TileTable, region_pieces
from slam2d_tpu_torch.parallel.mesh import Mesh


def _mine(table: TileTable, rc, n_local: int, mesh: Mesh):
    """The local index of world tile `rc` when this rank owns it, else
    None (also when the tile is not active)."""
    slot = table.slot(rc)
    if slot is None or slot // n_local != mesh.rank:
        return None
    return slot - mesh.rank * n_local


def gather_region_sharded(tiles_local, cfg: TileConfig, origin_rc,
                          size: int, table: TileTable, mesh: Mesh):
    """The [size, size] window whose global top-left cell is `origin_rc`
    (host ints), assembled over the ranks: a new tensor, the same on
    every rank. `tiles_local` [n_local, t, t] is this rank's block."""
    n_local = tiles_local.shape[0]
    out = torch.zeros((size, size), dtype=tiles_local.dtype,
                      device=tiles_local.device)
    for rc, wr, wc, qr, qc in region_pieces(origin_rc, (size, size),
                                            cfg.tile):
        k = _mine(table, rc, n_local, mesh)
        if k is not None:
            out[wr, wc] = tiles_local[k, qr, qc]
    return mesh.psum(out)


def scatter_region_sharded(tiles_local, cfg: TileConfig, window, origin_rc,
                           table: TileTable, mesh: Mesh):
    """Write the (replicated) `window` [h, w] back at global top-left cell
    `origin_rc` (host ints): this rank copies the pieces of the tiles it
    owns, IN PLACE in `tiles_local`, which it returns."""
    n_local = tiles_local.shape[0]
    for rc, wr, wc, qr, qc in region_pieces(origin_rc, tuple(window.shape),
                                            cfg.tile):
        k = _mine(table, rc, n_local, mesh)
        if k is not None:
            tiles_local[k, qr, qc] = window[wr, wc]
    return tiles_local
