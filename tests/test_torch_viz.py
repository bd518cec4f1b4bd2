"""PyTorch port: the map exports and the video frames (viz/ros_map.py,
viz/render.py, viz/video.py) against the JAX package's, on the CPU.

- The ROS map_server pair (PGM + YAML), bounded and tiled: byte-equal
  files for the same log-odds (torch.sigmoid against jax.nn.sigmoid; no
  cell of these maps lies within an ulp of a threshold).
- `load_ros_map` on the maps of tests/test_ros_map.py (a comment line and
  a padding byte, a negated map, a round trip): equal arrays and equal
  geometry.
- `compose_frame`: equal uint8 images; `VideoRecorder.add` given a tensor
  equal to the JAX recorder given the same numpy map; the GIF written.
- `save_map_png` / `save_tiled_map_png`: a PNG is written (matplotlib).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from slam2d_tpu.config import GridConfig as JGrid
from slam2d_tpu.grid import tiles as jtiles
from slam2d_tpu.viz import ros_map as jros
from slam2d_tpu.viz import video as jvideo
from slam2d_tpu_torch.config import GridConfig
from slam2d_tpu_torch.grid import tiles as ttiles
from slam2d_tpu_torch.viz import ros_map as tros
from slam2d_tpu_torch.viz import video as tvideo
from slam2d_tpu_torch.viz.render import save_map_png, save_tiled_map_png

GEOM = dict(height=64, width=96, resolution=0.05, center_x=1.0, center_y=2.0)
GCFG, JGCFG = GridConfig(**GEOM), JGrid(**GEOM)


def _logodds(seed=0, shape=(64, 96)):
    rng = np.random.default_rng(seed)
    lo = rng.normal(0.0, 2.5, shape).astype(np.float32)
    lo[rng.random(shape) < 0.3] = 0.0
    return lo


def _tiled(tile=32, n_slots=6):
    """A port TiledGrid, the JAX one and their configs: two active tiles
    side by side and one below, the rest free slots."""
    tcfg = ttiles.TileConfig(tile=tile, n_slots=n_slots, resolution=0.1,
                             origin_x=-1.0, origin_y=0.5)
    jcfg = jtiles.TileConfig(tile=tile, n_slots=n_slots, resolution=0.1,
                             origin_x=-1.0, origin_y=0.5)
    tiles = np.zeros((n_slots + 1, tile, tile), np.float32)
    coords = np.full((n_slots + 1, 2), ttiles.FREE_SLOT, np.int32)
    for k, rc in enumerate([(0, 0), (0, 1), (-1, 1)]):
        tiles[k] = _logodds(k, (tile, tile))
        coords[k] = rc
    port = ttiles.TiledGrid(torch.tensor(tiles), torch.tensor(coords))
    jax_ = jtiles.TiledGrid(tiles, coords)
    return port, jax_, tcfg, jcfg


def _pair_bytes(pgm, yaml):
    with open(pgm, "rb") as f, open(yaml, "rb") as g:
        return f.read(), g.read()


def test_ros_map_pair_is_byte_equal(tmp_path):
    lo = _logodds()
    os.makedirs(tmp_path / "p")
    os.makedirs(tmp_path / "j")
    port = tros.save_ros_map(str(tmp_path / "p" / "map"), torch.tensor(lo),
                             GCFG)
    ref = jros.save_ros_map(str(tmp_path / "j" / "map"), lo, JGCFG)
    assert _pair_bytes(*port) == _pair_bytes(*ref)


def test_tiled_ros_map_pair_is_byte_equal(tmp_path):
    port, jax_, tcfg, jcfg = _tiled()
    os.makedirs(tmp_path / "p")
    os.makedirs(tmp_path / "j")
    a = tros.save_tiled_ros_map(str(tmp_path / "p" / "tmap"), port, tcfg)
    b = jros.save_tiled_ros_map(str(tmp_path / "j" / "tmap"), jax_, jcfg)
    assert _pair_bytes(*a) == _pair_bytes(*b)
    back, g = tros.load_ros_map(a[1])
    assert back.shape == (64, 64)


def _write_real(tmp_path):
    H, W = 4, 8
    img = np.arange(0, 256, 8, dtype=np.uint8).reshape(H, W)
    with open(tmp_path / "real.pgm", "wb") as f:
        f.write(b"P5\n# CREATOR: map_saver.cpp 0.050 m/pix\n")
        f.write(f"{W} {H}\n255\n".encode())
        f.write(img.tobytes())
        f.write(b"\n")
    with open(tmp_path / "real.yaml", "w") as f:
        f.write("image: real.pgm\nresolution: 0.05\n"
                "origin: [0.0, 0.0, 0.0]\nnegate: 0\n"
                "occupied_thresh: 0.65\nfree_thresh: 0.196\n")
    return str(tmp_path / "real.yaml")


def _write_negated(tmp_path):
    H, W = 2, 4
    img = np.full((H, W), 205, np.uint8)
    img[0, 0] = 254
    img[1, 1] = 0
    with open(tmp_path / "n.pgm", "wb") as f:
        f.write(f"P5\n{W} {H}\n255\n".encode() + img.tobytes())
    with open(tmp_path / "n.yaml", "w") as f:
        f.write("image: n.pgm\nresolution: 0.1\norigin: [0, 0, 0]\n"
                "negate: 1\noccupied_thresh: 0.65\nfree_thresh: 0.196\n")
    return str(tmp_path / "n.yaml")


def _write_roundtrip(tmp_path):
    return jros.save_ros_map(str(tmp_path / "rt"), _logodds(3), JGCFG)[1]


@pytest.mark.parametrize("make", [_write_real, _write_negated,
                                  _write_roundtrip])
def test_load_ros_map_equals_jax(tmp_path, make):
    yaml = make(tmp_path)
    lo_t, g_t = tros.load_ros_map(yaml)
    lo_j, g_j = jros.load_ros_map(yaml)
    np.testing.assert_array_equal(lo_t, lo_j)
    assert lo_t.dtype == lo_j.dtype
    for f in ("height", "width", "resolution", "center_x", "center_y",
              "origin_x", "origin_y"):
        assert getattr(g_t, f) == getattr(g_j, f), f


def test_compose_frame_equals_jax():
    rng = np.random.default_rng(2)
    lo = _logodds(4, (300, 200))
    gcfg = dataclasses.replace(GCFG, height=300, width=200)
    jg = dataclasses.replace(JGCFG, height=300, width=200)
    traj = np.stack([rng.uniform(-3, 5, 40), rng.uniform(-5, 9, 40),
                     np.zeros(40)], 1).astype(np.float32)
    gt = traj + 0.05
    for max_dim in (640, 128):
        a = tvideo.compose_frame(lo, gcfg, traj=traj, gt=gt, max_dim=max_dim)
        b = jvideo.compose_frame(lo, jg, traj=traj, gt=gt, max_dim=max_dim)
        assert a.dtype == np.uint8 and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_video_recorder_takes_tensors(tmp_path):
    pytest.importorskip("PIL")
    rec = tvideo.VideoRecorder(str(tmp_path / "v.gif"), GCFG, every=2)
    ref = jvideo.VideoRecorder(str(tmp_path / "j.gif"), JGCFG, every=2)
    gt = np.zeros((12, 3), np.float32)
    rec.set_ground_truth(gt)
    ref.set_ground_truth(gt)
    for i in range(5):
        lo = _logodds(10 + i)
        chunk = np.full((2, 3), 0.1 * i, np.float32)
        rec.add(torch.tensor(lo), chunk)
        ref.add(lo, chunk)
    assert len(rec.frames) == len(ref.frames) == 3
    for a, b in zip(rec.frames, ref.frames):
        np.testing.assert_array_equal(a, b)
    path = rec.save()
    assert path.endswith(".gif") and os.path.getsize(path) > 100


def test_map_png(tmp_path):
    pytest.importorskip("matplotlib")
    out = save_map_png(str(tmp_path / "m.png"), torch.tensor(_logodds()),
                       GCFG, traj=np.zeros((5, 3), np.float32), title="t")
    assert os.path.getsize(out) > 1000
    port, _, tcfg, _ = _tiled()
    out = save_tiled_map_png(str(tmp_path / "t.png"), port, tcfg)
    assert os.path.getsize(out) > 1000
