"""Offline map and trajectory rendering, the counterpart of the JAX
package's slam2d_tpu/viz/render.py.

Host-side and decoupled from the pipelines: the map is read back once and
drawn once. matplotlib is imported lazily, so an installation without it
still runs every pipeline. Maps may be tensors (any device) or numpy
arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from slam2d_tpu_torch.config import GridConfig
from slam2d_tpu_torch.grid.occupancy import occupancy_prob


def _prob(logodds) -> np.ndarray:
    """p(occupied) [H, W] as numpy float32."""
    t = torch.as_tensor(logodds).detach().to("cpu", torch.float32)
    return occupancy_prob(t).numpy()


def render_map(
    logodds,
    gcfg: GridConfig,
    traj: np.ndarray | None = None,
    gt: np.ndarray | None = None,
    keyframes: np.ndarray | None = None,
    title: str = "",
):
    """Build a matplotlib figure of p(occupied) with trajectory overlays."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    p = _prob(logodds)
    H, W = p.shape
    extent = (
        gcfg.origin_x,
        gcfg.origin_x + W * gcfg.resolution,
        gcfg.origin_y,
        gcfg.origin_y + H * gcfg.resolution,
    )
    fig, ax = plt.subplots(figsize=(8, 8))
    ax.imshow(
        1.0 - p, cmap="gray", origin="lower", extent=extent, vmin=0.0, vmax=1.0
    )
    if gt is not None:
        ax.plot(gt[:, 0], gt[:, 1], "g-", lw=1.0, label="ground truth")
    if traj is not None:
        ax.plot(traj[:, 0], traj[:, 1], "r-", lw=1.0, label="estimate")
    if keyframes is not None and len(keyframes):
        ax.plot(keyframes[:, 0], keyframes[:, 1], "b.", ms=3, label="keyframes")
    if traj is not None or gt is not None or keyframes is not None:
        ax.legend(loc="upper right", fontsize=8)
    ax.set_title(title)
    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")
    return fig


def save_map_png(path: str, logodds, gcfg: GridConfig, **kw) -> str:
    fig = render_map(logodds, gcfg, **kw)
    fig.savefig(path, dpi=130, bbox_inches="tight")
    import matplotlib.pyplot as plt

    plt.close(fig)
    return path


def stitched_grid(tiled_grid, tcfg):
    """(dense [H, W] numpy map, GridConfig) of an unbounded tiled map's
    active tiles, stitched by grid/tiles.py:stitch_tiles."""
    from slam2d_tpu_torch.grid.tiles import stitch_tiles

    dense, (ox, oy) = stitch_tiles(tiled_grid, tcfg)
    H, W = dense.shape
    gcfg = GridConfig(
        height=H, width=W, resolution=tcfg.resolution,
        center_x=ox + (W // 2) * tcfg.resolution,
        center_y=oy + (H // 2) * tcfg.resolution,
    )
    return dense, gcfg


def save_tiled_map_png(path: str, tiled_grid, tcfg, **kw) -> str:
    """Stitch an unbounded tiled map's active tiles and render them."""
    dense, gcfg = stitched_grid(tiled_grid, tcfg)
    return save_map_png(path, dense, gcfg, **kw)
