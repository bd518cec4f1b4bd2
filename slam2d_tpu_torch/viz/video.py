"""Map-build animation export, the port's copy of the JAX package's
slam2d_tpu/viz/video.py.

Frames are captured at chunk boundaries, off the device's path: one map
read per chunk, opt-in (`--save-video`), so the pipelines read nothing
back unless a video was asked for. `VideoRecorder.add` takes the map as
a tensor on any device (or a numpy array). Frames are composed as pure numpy uint8 images immediately (bounded
memory: one [H, W, 3] uint8 per frame, downsampled to `max_dim`).
Assembly: animated GIF via PIL, or MP4 via OpenCV's bundled codec,
picked by file extension, with GIF fallback if the MP4 encoder is
unavailable. PIL and OpenCV are imported only to save.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from slam2d_tpu_torch.config import GridConfig

# palette (uint8 RGB)
_TRAJ = np.array([220, 40, 40], np.uint8)
_GT = np.array([40, 170, 40], np.uint8)
_POSE = np.array([40, 80, 230], np.uint8)


def compose_frame(
    logodds: np.ndarray,
    gcfg: GridConfig,
    traj: np.ndarray | None = None,
    gt: np.ndarray | None = None,
    max_dim: int = 640,
) -> np.ndarray:
    """[H, W, 3] uint8: grayscale p(occupied) (white=free, black=wall),
    trajectory in red, ground truth in green, current pose marked blue.
    World y points up, so rows are flipped for display."""
    l = np.asarray(logodds, np.float32)
    p = 1.0 - 1.0 / (1.0 + np.exp(np.clip(l, -30.0, 30.0)))
    stride = max(1, int(np.ceil(max(p.shape) / max_dim)))
    p = p[::stride, ::stride]
    gray = np.clip((1.0 - p) * 255.0, 0, 255).astype(np.uint8)
    img = np.repeat(gray[:, :, None], 3, axis=2)
    H, W = gray.shape

    def draw(points, color, thick=0):
        if points is None or len(points) == 0:
            return
        pts = np.asarray(points, np.float32)
        cc = ((pts[:, 0] - gcfg.origin_x) / gcfg.resolution / stride)
        rr = ((pts[:, 1] - gcfg.origin_y) / gcfg.resolution / stride)
        cc = np.round(cc).astype(np.int64)
        rr = np.round(rr).astype(np.int64)
        ok = (rr >= 0) & (rr < H) & (cc >= 0) & (cc < W)
        rr, cc = rr[ok], cc[ok]
        for dr in range(-thick, thick + 1):
            for dc in range(-thick, thick + 1):
                r2 = np.clip(rr + dr, 0, H - 1)
                c2 = np.clip(cc + dc, 0, W - 1)
                img[r2, c2] = color

    draw(gt, _GT)
    draw(traj, _TRAJ)
    if traj is not None and len(traj):
        draw(traj[-1:], _POSE, thick=2)
    return img[::-1]  # row 0 at the bottom (world y up)


class VideoRecorder:
    """Collects per-chunk frames and writes a GIF or MP4.

    Usage: pass `recorder.add` as a runner's `frame_cb`; call `save()`
    after the run. `every` subsamples chunk boundaries (frame i is kept
    when i % every == 0); the final state is always appended by save()
    callers that want it via one last add()."""

    def __init__(
        self,
        path: str,
        gcfg: GridConfig,
        fps: int = 10,
        max_dim: int = 640,
        every: int = 1,
    ):
        self.path = path
        self.gcfg = gcfg
        self.fps = fps
        self.max_dim = max_dim
        self.every = max(1, every)
        self.frames: list[np.ndarray] = []
        self._traj: list[np.ndarray] = []
        self._gt = None
        self._i = 0

    def set_ground_truth(self, gt) -> None:
        self._gt = np.asarray(gt, np.float32) if gt is not None else None

    def add(self, logodds, traj_chunk=None) -> None:
        """Record one chunk boundary. `logodds` [H, W] (device or host);
        `traj_chunk` [k, 3] poses newly produced this chunk (appended to
        the running trajectory overlay)."""
        if traj_chunk is not None and len(traj_chunk):
            self._traj.append(np.asarray(traj_chunk, np.float32))
        i = self._i
        self._i += 1
        if i % self.every:
            return
        traj = np.concatenate(self._traj) if self._traj else None
        gt = self._gt[: len(traj)] if (
            self._gt is not None and traj is not None
        ) else None
        if isinstance(logodds, torch.Tensor):
            logodds = logodds.detach().to("cpu", torch.float32).numpy()
        self.frames.append(
            compose_frame(
                np.asarray(logodds), self.gcfg, traj=traj, gt=gt,
                max_dim=self.max_dim,
            )
        )

    def save(self) -> str:
        """Write the animation; returns the path actually written (falls
        back to .gif when an MP4 encoder is unavailable)."""
        if not self.frames:
            raise ValueError("no frames recorded")
        path = self.path
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        if path.endswith(".mp4"):
            try:
                return self._save_mp4(path)
            except Exception:
                path = path[:-4] + ".gif"
        return self._save_gif(path)

    def _save_gif(self, path: str) -> str:
        from PIL import Image

        ims = [Image.fromarray(f) for f in self.frames]
        ims[0].save(
            path, save_all=True, append_images=ims[1:],
            duration=max(1, int(1000 / self.fps)), loop=0,
        )
        return path

    def _save_mp4(self, path: str) -> str:
        import cv2

        h, w = self.frames[0].shape[:2]
        # even dims for broad codec compatibility
        w2, h2 = w - (w % 2), h - (h % 2)
        vw = cv2.VideoWriter(
            path, cv2.VideoWriter_fourcc(*"mp4v"), self.fps, (w2, h2)
        )
        if not vw.isOpened():
            raise RuntimeError("mp4 encoder unavailable")
        for f in self.frames:
            vw.write(cv2.cvtColor(f[:h2, :w2], cv2.COLOR_RGB2BGR))
        vw.release()
        return path
