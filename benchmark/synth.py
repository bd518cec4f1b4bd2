"""The benchmark's log generator: a frozen copy of slam2d_tpu_torch/data/
synth.py at commit fe37ab964ea616f84f82d44417eea1bff9015b6b
(`SynthWorld.box_rooms`, `SynthWorld.raycast`, `_waypoint_trajectory`,
`simulate_log`, `_wrap`), numpy only. A known line-segment world is
raycast along a known trajectory to give CARMEN-style records: ground
truth, drifting noisy odometry and noisy range scans. The same seed gives
the same arrays as the program's copy at that commit
(benchmark/tests/test_bench_traffic.py). Later changes to the program's
copy do not move the benchmark's logs.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class SynthWorld:
    """World = set of line segments [N, 4] as (x0, y0, x1, y1)."""

    segments: np.ndarray

    @staticmethod
    def box_rooms(size: float = 20.0) -> "SynthWorld":
        """A bounded box with a few interior walls and an obstacle block."""
        s = size
        segs = [
            # outer box
            (0, 0, s, 0), (s, 0, s, s), (s, s, 0, s), (0, s, 0, 0),
            # interior walls with door gaps
            (0.3 * s, 0, 0.3 * s, 0.45 * s),
            (0.3 * s, 0.6 * s, 0.3 * s, s),
            (0.3 * s, 0.55 * s, 0.7 * s, 0.55 * s),
            (0.7 * s, 0.55 * s, 0.7 * s, 0.2 * s),
            # an obstacle block
            (0.55 * s, 0.75 * s, 0.65 * s, 0.75 * s),
            (0.65 * s, 0.75 * s, 0.65 * s, 0.85 * s),
            (0.65 * s, 0.85 * s, 0.55 * s, 0.85 * s),
            (0.55 * s, 0.85 * s, 0.55 * s, 0.75 * s),
        ]
        return SynthWorld(np.asarray(segs, dtype=np.float64))

    def raycast(self, pose: np.ndarray, angles: np.ndarray, max_range: float):
        """Exact ray/segment intersection. pose [3]; angles [B] world-frame
        offsets added to pose theta. Returns ranges [B] (max_range if no
        hit)."""
        ox, oy, th = pose
        a = th + angles
        dx, dy = np.cos(a), np.sin(a)                       # [B]
        x0, y0, x1, y1 = self.segments.T                    # [N]
        ex, ey = x1 - x0, y1 - y0

        # Solve o + t*d = p0 + u*e  for t >= 0, 0 <= u <= 1.
        denom = dx[:, None] * (-ey)[None, :] + dy[:, None] * ex[None, :]
        denom = np.where(np.abs(denom) < 1e-12, np.nan, denom)
        rx = x0[None, :] - ox
        ry = y0[None, :] - oy
        t = (rx * (-ey)[None, :] + ry * ex[None, :]) / denom
        u = (dx[:, None] * ry - dy[:, None] * rx) / denom
        t = np.where((t >= 1e-9) & (u >= 0.0) & (u <= 1.0), t, np.inf)
        r = np.nanmin(np.where(np.isnan(t), np.inf, t), axis=1)
        return np.minimum(r, max_range)


def _waypoint_trajectory(waypoints: np.ndarray, step: float) -> np.ndarray:
    """Constant-speed poses [T, 3] along a waypoint polyline, heading along
    the direction of travel."""
    poses = []
    for k in range(len(waypoints) - 1):
        p0, p1 = waypoints[k], waypoints[k + 1]
        d = p1 - p0
        dist = float(np.hypot(*d))
        th = float(np.arctan2(d[1], d[0]))
        n = max(int(dist / step), 1)
        for i in range(n):
            xy = p0 + d * (i / n)
            poses.append([xy[0], xy[1], th])
    poses.append([waypoints[-1][0], waypoints[-1][1], poses[-1][2]])
    return np.asarray(poses, dtype=np.float64)


def simulate_log(world: SynthWorld, waypoints: np.ndarray, beam_angles,
                 max_range: float, step: float = 0.1,
                 odom_noise_xy: float = 0.004,
                 odom_noise_theta: float = 0.002,
                 range_noise: float = 0.01, seed: int = 0):
    """Simulate a CARMEN-style log along `waypoints` with a scanner whose
    beams lie at `beam_angles` [B] (float64, relative to the heading).

    Returns a dict of float32 arrays: gt_poses [T, 3], odom [T, 3]
    (integrated noisy deltas), ranges [T, B] (max_range where no hit)."""
    rng = np.random.default_rng(seed)
    gt = _waypoint_trajectory(waypoints, step)
    angles = np.asarray(beam_angles, np.float64)

    T = len(gt)
    ranges = np.empty((T, len(angles)), dtype=np.float64)
    for t in range(T):
        r = world.raycast(gt[t], angles, max_range)
        hit = r < max_range
        r = np.where(hit, r + rng.normal(0.0, range_noise, r.shape), r)
        ranges[t] = np.clip(r, 0.0, max_range)

    # Odometry: integrate true SE(2) deltas corrupted by noise.
    odom = np.empty_like(gt)
    odom[0] = gt[0]
    for t in range(1, T):
        c, s = np.cos(gt[t - 1, 2]), np.sin(gt[t - 1, 2])
        dwx, dwy = gt[t, 0] - gt[t - 1, 0], gt[t, 1] - gt[t - 1, 1]
        # true delta in body frame
        dx = c * dwx + s * dwy + rng.normal(0.0, odom_noise_xy)
        dy = -s * dwx + c * dwy + rng.normal(0.0, odom_noise_xy)
        dth = _wrap(gt[t, 2] - gt[t - 1, 2]) + rng.normal(0.0, odom_noise_theta)
        co, so = np.cos(odom[t - 1, 2]), np.sin(odom[t - 1, 2])
        odom[t, 0] = odom[t - 1, 0] + co * dx - so * dy
        odom[t, 1] = odom[t - 1, 1] + so * dx + co * dy
        odom[t, 2] = _wrap(odom[t - 1, 2] + dth)

    return {
        "gt_poses": gt.astype(np.float32),
        "odom": odom.astype(np.float32),
        "ranges": ranges.astype(np.float32),
    }


def _wrap(a):
    return (a + np.pi) % (2 * np.pi) - np.pi
