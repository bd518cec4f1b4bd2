"""Tiled, world-anchored occupancy map, port of slam2d_tpu/grid/tiles.py.

The world is an unbounded integer lattice of fixed-size tiles; the device
holds a fixed pool of tile slots:

    tiles  [N+1, t, t]  log-odds (or search-space) content per slot
    coords [N+1, 2]     world tile index (row, col) per slot, FREE_SLOT=free

Slot N is the trash slot: a write to a tile that is not active lands there
and is discarded; its content is unspecified. A tile that is not active
reads as 0 and the trash slot is never read.

Activating a tile (`TileTable.activate`) is a host table update: a free
slot gets the tile's coordinates, and the host table is copied into the
device `coords` in place (the buffer keeps its address, so a captured
CUDA graph that reads it stays valid), so the two stay equal.

The region ops gather and scatter a [h, w] window whose global top-left
cell is given. The frontend's (`gather_region_t`, `scatter_region_t`)
take it as an int32 device tensor and find the slots from the device
`coords`, as the JAX package's `lookup_slot` does, with nothing read to
the host: each window row and column splits into a tile index (floor
division) and an offset (`torch.remainder`: global cells go negative),
each of the ceil((h - 1) / t) + 1 by ceil((w - 1) / t) + 1 tiles the
window can overlap gets its slot, and the window is one flat gather, or
one flat `index_put_`, of the pool. The host forms (`gather_region`,
`scatter_region`) take a host origin and the host `TileTable`, and copy
the overlapping tile pieces, one to three a side: full SLAM's rebuild
places its windows on the host, and run eagerly the host forms' few
copies a window cost less than the device forms' index arithmetic
(scripts/bench_tiled_rebuild_torch.py). The JAX package's one-hot matmul form
was a TPU workaround for slow gathers; both forms give its bits.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from slam2d_tpu_torch.core.numerics import inv_f32

FREE_SLOT = np.int32(-(2**31))  # sentinel coord for an unused slot


@dataclasses.dataclass(frozen=True)
class TileConfig:
    tile: int = 512            # cells per tile side
    n_slots: int = 64          # device tile-pool capacity (excl. trash slot)
    resolution: float = 0.05   # meters per cell
    # world position of cell (0, 0) of tile (0, 0)
    origin_x: float = 0.0
    origin_y: float = 0.0
    l_clamp: float = 10.0


class TiledGrid(NamedTuple):
    tiles: torch.Tensor   # [N+1, t, t] float32
    coords: torch.Tensor  # [N+1, 2] int32 world tile indices; FREE_SLOT=empty


def tiled_init(cfg: TileConfig, device="cuda") -> TiledGrid:
    """An empty pool on `device`: every tile 0, every slot free."""
    n = cfg.n_slots + 1
    return TiledGrid(
        tiles=torch.zeros((n, cfg.tile, cfg.tile), dtype=torch.float32,
                          device=device),
        coords=torch.full((n, 2), int(FREE_SLOT), dtype=torch.int32,
                          device=device),
    )


def world_to_cell_global(xy, cfg: TileConfig):
    """World (x, y) -> global integer (row, col) on the unbounded lattice.
    The JAX package divides by the resolution under jit, which XLA
    compiles as a multiplication by its float32 reciprocal (inv_f32)."""
    col = torch.floor((xy[..., 0] - cfg.origin_x) * inv_f32(cfg.resolution))
    row = torch.floor((xy[..., 1] - cfg.origin_y) * inv_f32(cfg.resolution))
    return torch.stack([row, col], dim=-1).to(torch.int32)


def lookup_slot(coords_table, tile_rc):
    """(slot index, found) for world tile (row, col) as 0-d tensors; the
    trash slot if absent."""
    n = coords_table.shape[0] - 1
    hit = torch.all(coords_table[:n] == tile_rc[None, :], dim=1)
    found = torch.any(hit)
    slot = torch.argmax(hit.to(torch.int32))
    return torch.where(found, slot, n).to(torch.int32), found


def required_tiles(poses_xy: np.ndarray, reach_m: float, cfg: TileConfig):
    """HOST helper: set of world tile (row, col) a trajectory segment plus
    sensor reach can touch. Conservative bounding boxes per pose."""
    need = set()
    t = cfg.tile * cfg.resolution
    for x, y in np.asarray(poses_xy).reshape(-1, 2):
        r0 = math.floor((y - cfg.origin_y - reach_m) / t)
        r1 = math.floor((y - cfg.origin_y + reach_m) / t)
        c0 = math.floor((x - cfg.origin_x - reach_m) / t)
        c1 = math.floor((x - cfg.origin_x + reach_m) / t)
        for r in range(r0, r1 + 1):
            for c in range(c0, c1 + 1):
                need.add((r, c))
    return need


class TileTable:
    """HOST-side mirror of the slot table; owns activation decisions."""

    def __init__(self, cfg: TileConfig):
        self.cfg = cfg
        self.slot_of: dict[tuple[int, int], int] = {}
        self.coords = np.full((cfg.n_slots + 1, 2), FREE_SLOT, np.int32)

    @classmethod
    def from_coords(cls, cfg: TileConfig, coords) -> "TileTable":
        """The table of a pool whose `coords` ([N+1, 2], numpy or a tensor,
        which is read to the host) are given, e.g. a carried state's."""
        table = cls(cfg)
        c = (coords.cpu().numpy() if isinstance(coords, torch.Tensor)
             else np.asarray(coords)).astype(np.int32)
        if c.shape != table.coords.shape:
            raise ValueError(f"coords of shape {c.shape}, the pool has "
                             f"{table.coords.shape}")
        table.coords[:] = c
        table.coords[-1] = FREE_SLOT
        for k in np.flatnonzero(c[:-1, 0] > FREE_SLOT):
            table.slot_of[(int(c[k, 0]), int(c[k, 1]))] = int(k)
        return table

    def activate(self, grid: TiledGrid, tiles_needed) -> TiledGrid:
        """Assign free slots to any unseen tiles and copy the host table
        into the grid's device `coords` IN PLACE (the JAX package returns
        a grid with new coords); returns the grid. Raises if the pool is
        exhausted (capacity is a config decision). The lowest free slot is
        taken: a table built by `activate` fills slots 0, 1, ... as the
        JAX package's does."""
        changed = False
        for rc in tiles_needed:
            rc = (int(rc[0]), int(rc[1]))
            if rc in self.slot_of:
                continue
            free = np.flatnonzero(self.coords[:-1, 0] == FREE_SLOT)
            if not len(free):
                raise RuntimeError(
                    f"tile pool exhausted ({self.cfg.n_slots} slots); "
                    "raise TileConfig.n_slots"
                )
            slot = int(free[0])
            self.slot_of[rc] = slot
            self.coords[slot] = rc
            changed = True
        if changed:
            grid.coords.copy_(torch.from_numpy(self.coords.copy()))
        return grid

    def slot(self, rc):
        """The slot of world tile `rc`, or None if it is not active."""
        return self.slot_of.get((int(rc[0]), int(rc[1])))


def stitch_tiles(grid: TiledGrid, cfg: TileConfig):
    """HOST helper: assemble all active tiles into one dense array for
    rendering/export. Returns (dense [H, W] np.ndarray, origin_xy)."""
    coords = grid.coords[:-1].cpu().numpy()
    tiles = grid.tiles[:-1].cpu().numpy()
    active = coords[:, 0] > FREE_SLOT
    if not active.any():
        return np.zeros((cfg.tile, cfg.tile), np.float32), (cfg.origin_x, cfg.origin_y)
    rc = coords[active]
    r0, c0 = rc[:, 0].min(), rc[:, 1].min()
    r1, c1 = rc[:, 0].max() + 1, rc[:, 1].max() + 1
    H = int(r1 - r0) * cfg.tile
    W = int(c1 - c0) * cfg.tile
    dense = np.zeros((H, W), np.float32)
    for k in np.flatnonzero(active):
        rr = int(coords[k, 0] - r0) * cfg.tile
        cc = int(coords[k, 1] - c0) * cfg.tile
        dense[rr : rr + cfg.tile, cc : cc + cfg.tile] = tiles[k]
    origin = (
        cfg.origin_x + int(c0) * cfg.tile * cfg.resolution,
        cfg.origin_y + int(r0) * cfg.tile * cfg.resolution,
    )
    return dense, origin


def region_pieces(origin_rc, shape, tile: int):
    """The pieces of a window of `shape` (h, w) whose global top-left cell
    is the host integer pair `origin_rc`, one per tile it overlaps: lists
    of ((tile row, tile col), window rows, window cols, tile rows, tile
    cols), each range a slice."""
    r0, c0 = int(origin_rc[0]), int(origin_rc[1])
    h, w = shape

    def spans(start, n):
        out = []
        for k in range(start // tile, (start + n - 1) // tile + 1):
            lo, hi = max(start, k * tile), min(start + n, (k + 1) * tile)
            out.append((k, slice(lo - start, hi - start),
                        slice(lo - k * tile, hi - k * tile)))
        return out

    return [
        ((tr, tc), wr, wc, qr, qc)
        for tr, wr, qr in spans(r0, h)
        for tc, wc, qc in spans(c0, w)
    ]


def gather_region(grid: TiledGrid, cfg: TileConfig, origin_rc, size: int,
                  table: TileTable):
    """The [size, size] window whose global top-left cell is origin_rc
    (host ints), a new tensor. Missing tiles read as zeros. One copy (or
    fill) a tile the window overlaps; `table` (the pool's TileTable)
    gives the slots."""
    out = torch.empty((size, size), dtype=grid.tiles.dtype,
                      device=grid.tiles.device)
    for rc, wr, wc, qr, qc in region_pieces(origin_rc, (size, size),
                                            cfg.tile):
        slot = table.slot(rc)
        if slot is None:
            out[wr, wc] = 0.0
        else:
            out[wr, wc] = grid.tiles[slot, qr, qc]
    return out


def scatter_region(grid: TiledGrid, cfg: TileConfig, window, origin_rc,
                   table: TileTable) -> TiledGrid:
    """Write `window` [h, w] back at global top-left cell origin_rc (host
    ints), IN PLACE in `grid.tiles` (the JAX package returns a new grid),
    and return the grid. Each overlapped tile's piece becomes
    t + (window - t) in float32, the value the JAX package's one-hot form
    writes (equal to the window's value wherever the subtraction is
    exact); a piece of a tile that is not active goes to the trash slot.
    Two operations a tile; `table` (the pool's TileTable) gives the
    slots."""
    trash = grid.tiles.shape[0] - 1
    for rc, wr, wc, qr, qc in region_pieces(origin_rc, tuple(window.shape),
                                            cfg.tile):
        slot = table.slot(rc)
        dst = grid.tiles[trash if slot is None else slot, qr, qc]
        dst += window[wr, wc] - dst
    return grid


def _region_index(coords, origin, size, tile: int, gate=None):
    """([h, w] int64 flat indices into a pool's tiles of the cells of the
    (h, w) = `size` window whose global top-left cell is the int32 device
    tensor `origin` [2], [h, w] bool: the cell's tile is active). A cell
    of a tile that is not active, or any cell where the bool device tensor
    `gate` is false, indexes the trash slot. Nothing is read to the host."""
    h, w = size
    n = coords.shape[0] - 1
    dev = coords.device
    o = origin.to(torch.int64)
    rows = o[0] + torch.arange(h, dtype=torch.int64, device=dev)
    cols = o[1] + torch.arange(w, dtype=torch.int64, device=dev)
    base = torch.div(o, tile, rounding_mode="floor")
    # the tiles the window can overlap, and their slots (lookup_slot's)
    nr, nc = -(-(h - 1) // tile) + 1, -(-(w - 1) // tile) + 1
    cand = torch.stack(torch.broadcast_tensors(
        base[0] + torch.arange(nr, device=dev)[:, None],
        base[1] + torch.arange(nc, device=dev)[None, :]), dim=-1)
    hit = torch.all(coords[None, None, :n].to(torch.int64)
                    == cand[:, :, None, :], dim=-1)        # [nr, nc, n]
    found = torch.any(hit, dim=-1)
    live = found if gate is None else found & gate.reshape(())
    slot = torch.where(live, torch.argmax(hit.to(torch.int32), dim=-1), n)
    ar = (torch.div(rows, tile, rounding_mode="floor") - base[0])[:, None]
    ac = (torch.div(cols, tile, rounding_mode="floor") - base[1])[None, :]
    flat = (slot[ar, ac] * (tile * tile)
            + torch.remainder(rows, tile)[:, None] * tile
            + torch.remainder(cols, tile)[None, :])
    return flat, found[ar, ac]


def gather_region_t(grid: TiledGrid, cfg: TileConfig, origin, size: int):
    """`gather_region` at the int32 device origin `origin` [2], the slots
    from the device coords: the [size, size] window, a new tensor (one
    gather of the pool); missing tiles read as zeros."""
    flat, found = _region_index(grid.coords, origin, (size, size), cfg.tile)
    return torch.where(found, torch.take(grid.tiles, flat), 0.0)


def scatter_region_t(grid: TiledGrid, cfg: TileConfig, window, origin,
                     gate=None) -> TiledGrid:
    """`scatter_region` at the int32 device origin `origin` [2], the slots
    from the device coords, IN PLACE in `grid.tiles`, when the bool device
    tensor `gate` is true (None: always): each active tile's cells become
    t + (window - t) in float32; a cell of a tile that is not active, and
    every cell on a gate of 0, goes to the trash slot, so a gated-off
    scatter leaves every tile bit-identical. One flat index_put_ of the
    pool. Returns the grid."""
    flat, _ = _region_index(grid.coords, origin, tuple(window.shape),
                            cfg.tile, gate)
    flat = flat.reshape(-1)
    pool = grid.tiles.view(-1)
    t = pool[flat]
    pool.index_put_((flat,), t + (window.reshape(-1) - t))
    return grid

