"""ROS map_server-format occupancy map export (PGM + YAML).

The reference ecosystem's standard interchange for 2D occupancy maps is
the ROS `map_saver` pair: a binary P5 PGM (0 = occupied, 254 = free,
205 = unknown, rows top-down) plus a YAML stanza with resolution and the
lower-left origin. Exporting it lets any ROS/nav2 stack (rviz,
map_server, AMCL) consume maps built by this framework directly.

The port's copy of the JAX package's slam2d_tpu/viz/ros_map.py: the same
bytes for the same log-odds. The map may be a tensor on any device; no
ROS, no matplotlib."""

from __future__ import annotations

import numpy as np

from slam2d_tpu_torch.config import GridConfig
from slam2d_tpu_torch.viz.render import _prob, stitched_grid

OCCUPIED_THRESH = 0.65
FREE_THRESH = 0.196


def _to_pgm_bytes(p: np.ndarray) -> bytes:
    """Map p(occupied) to map_saver's trinary PGM values, rows top-down."""
    img = np.full(p.shape, 205, np.uint8)        # unknown
    img[p > OCCUPIED_THRESH] = 0                 # occupied
    img[p < FREE_THRESH] = 254                   # free
    img = img[::-1]                              # row 0 = top (max y)
    header = f"P5\n{img.shape[1]} {img.shape[0]}\n255\n".encode()
    return header + img.tobytes()


def save_ros_map(path_stem: str, logodds, gcfg: GridConfig) -> tuple[str, str]:
    """Write `<stem>.pgm` + `<stem>.yaml`; returns the two paths."""
    p = _prob(logodds)
    pgm_path = path_stem + ".pgm"
    yaml_path = path_stem + ".yaml"
    with open(pgm_path, "wb") as f:
        f.write(_to_pgm_bytes(p))
    image_name = pgm_path.rsplit("/", 1)[-1]
    with open(yaml_path, "w") as f:
        f.write(
            f"image: {image_name}\n"
            f"resolution: {gcfg.resolution}\n"
            f"origin: [{gcfg.origin_x}, {gcfg.origin_y}, 0.0]\n"
            "negate: 0\n"
            f"occupied_thresh: {OCCUPIED_THRESH}\n"
            f"free_thresh: {FREE_THRESH}\n"
        )
    return pgm_path, yaml_path


def save_tiled_ros_map(path_stem: str, tiled_grid, tcfg) -> tuple[str, str]:
    """Stitch an unbounded tiled map's active tiles and export them."""
    dense, gcfg = stitched_grid(tiled_grid, tcfg)
    return save_ros_map(path_stem, dense, gcfg)


def load_ros_map(yaml_path: str) -> tuple[np.ndarray, GridConfig]:
    """Read back a map_server pair into (logodds [H, W], GridConfig).

    Honors the YAML's `negate` and occupancy thresholds and PGM comment
    lines, so genuine ROS map_saver output loads — not just this module's
    own files. Trinary inverse of save_ros_map: occupied cells get +4
    log-odds, free cells -4, unknown 0 — saturated evidence consistent
    with the thresholds. Used for localization against a prebuilt map and
    for round-trip tests."""
    meta: dict[str, str] = {}
    with open(yaml_path) as f:
        for line in f:
            if ":" in line:
                k, v = line.split(":", 1)
                meta[k.strip()] = v.strip()
    res = float(meta["resolution"])
    origin = [float(x) for x in meta["origin"].strip("[]").split(",")[:2]]
    negate = int(meta.get("negate", "0"))
    occ_th = float(meta.get("occupied_thresh", OCCUPIED_THRESH))
    free_th = float(meta.get("free_thresh", FREE_THRESH))
    img_path = meta["image"]
    if "/" not in img_path and "/" in yaml_path:
        img_path = yaml_path.rsplit("/", 1)[0] + "/" + img_path
    with open(img_path, "rb") as f:
        data = f.read()
    # P5 header: magic, width, height, maxval as whitespace-separated
    # tokens, '#'-comment lines allowed anywhere in the header; ONE
    # whitespace byte after maxval, then exactly H*W raster bytes
    # (trailing bytes are padding some writers emit — never read them).
    pos = 0
    tokens = []
    while len(tokens) < 4:
        if data[pos : pos + 1] == b"#":
            pos = data.index(b"\n", pos) + 1
            continue
        if data[pos : pos + 1].isspace():
            pos += 1
            continue
        end = pos
        while not data[end : end + 1].isspace():
            end += 1
        tokens.append(data[pos:end])
        pos = end
    assert tokens[0] == b"P5", "not a binary PGM"
    W, H = int(tokens[1]), int(tokens[2])
    maxval = int(tokens[3])
    pos += 1                                   # the single post-maxval byte
    img = np.frombuffer(data[pos : pos + H * W], np.uint8).reshape(H, W)[::-1]
    # map_server semantics: p(occ) = (maxval - v)/maxval, inverted by negate
    pocc = img.astype(np.float32) / maxval
    if not negate:
        pocc = 1.0 - pocc
    logodds = np.zeros((H, W), np.float32)
    logodds[pocc > occ_th] = 4.0
    logodds[pocc < free_th] = -4.0
    gcfg = GridConfig(
        height=H, width=W, resolution=res,
        center_x=origin[0] + (W // 2) * res,
        center_y=origin[1] + (H // 2) * res,
    )
    return logodds, gcfg
