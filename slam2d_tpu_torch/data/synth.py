"""Synthetic 2D world and log simulator, numpy only.

A copy of the JAX package's slam2d_tpu/data/synth.py (SynthWorld,
_waypoint_trajectory, simulate_log, corridor_world, corridor_loop_log,
endurance_log, splice_odom, default_log): a known line-segment world is
raycast along a known trajectory to give CARMEN-style records, namely
ground-truth poses, drifting noisy odometry and noisy range scans. The same seed gives the
same arrays in both packages.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from slam2d_tpu_torch.config import SensorConfig


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
        offsets added to pose theta. Returns ranges [B] (max_range if no hit).
        """
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


def simulate_log(
    world: SynthWorld,
    waypoints: np.ndarray,
    sensor: SensorConfig,
    step: float = 0.1,
    odom_noise_xy: float = 0.004,
    odom_noise_theta: float = 0.002,
    range_noise: float = 0.01,
    seed: int = 0,
):
    """Simulate a CARMEN-style log.

    Returns dict with float32 arrays:
      gt_poses   [T, 3]  ground-truth robot poses
      odom       [T, 3]  drifting odometry poses (integrated noisy deltas)
      ranges     [T, B]  noisy ranges (max_range where no hit)
    """
    rng = np.random.default_rng(seed)
    gt = _waypoint_trajectory(waypoints, step)
    angles = np.asarray(sensor.beam_angles())

    T = len(gt)
    ranges = np.empty((T, sensor.n_beams), dtype=np.float64)
    for t in range(T):
        r = world.raycast(gt[t], angles, sensor.max_range)
        hit = r < sensor.max_range
        r = np.where(hit, r + rng.normal(0.0, range_noise, r.shape), r)
        ranges[t] = np.clip(r, 0.0, sensor.max_range)

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


def corridor_world(span: float = 60.0, width: float = 3.0) -> SynthWorld:
    """MIT-Killian-style world: a large rectangular loop of corridors with
    cross-connections and door alcoves (structure along every wall so the
    matcher has features in both axes)."""
    s, w = span, width
    segs = []

    def box(x0, y0, x1, y1):
        segs.extend(
            [(x0, y0, x1, y0), (x1, y0, x1, y1), (x1, y1, x0, y1), (x0, y1, x0, y0)]
        )

    # outer boundary and inner block => a ring corridor of width w
    box(0, 0, s, s)
    box(w, w, s - w, s - w)
    # alcoves / doorframes along the inner block (feature texture)
    for t in np.arange(2 * w, s - 2 * w, 6.0):
        segs.append((t, w, t, w + 0.4))
        segs.append((w, t, w + 0.4, t))
        segs.append((t + 3.0, s - w, t + 3.0, s - w - 0.4))
        segs.append((s - w, t + 3.0, s - w - 0.4, t + 3.0))
    # a few pillars in the outer boundary walls
    for t in np.arange(4.0, s - 4.0, 8.0):
        segs.append((t, 0.0, t, 0.3))
        segs.append((0.0, t, 0.3, t))
        segs.append((t, s, t, s - 0.3))
        segs.append((s, t, s - 0.3, t))
    return SynthWorld(np.asarray(segs, dtype=np.float64))


def corridor_loop_log(
    sensor: SensorConfig | None = None,
    span: float = 60.0,
    step: float = 0.2,
    seed: int = 0,
    **noise,
):
    """A full lap around the ring corridor (closes a big loop at the end).
    Returns (world, log)."""
    sensor = sensor or SensorConfig()
    world = corridor_world(span)
    m = 1.5  # corridor centerline offset
    wp = np.asarray(
        [
            [m, m], [m, span - m], [span - m, span - m],
            [span - m, m], [m + 0.5, m],
        ]
    )
    return world, simulate_log(world, wp, sensor, step=step, seed=seed, **noise)


def endurance_log(
    sensor: SensorConfig | None = None,
    span: float = 28.0,
    laps: int = 3,
    step: float = 0.03,
    seed: int = 0,
    **noise,
):
    """An endurance log matched to the Intel Research Lab log's statistics
    (the real logs are not on disk): `laps` laps of the ring corridor at
    ~3 cm a scan, 180 beams, every scan after the first lap revisiting
    mapped territory. Each lap runs at a small lane offset drawn with
    seed + 1000 (revisits are near, not identical). laps=4 at step=0.03
    over the 28 m ring gives 13,337 scans. Returns (world, log) like
    corridor_loop_log."""
    sensor = sensor or SensorConfig()
    world = corridor_world(span)
    m = 1.5
    rng = np.random.default_rng(seed + 1000)
    wp = []
    for lap in range(laps):
        off = float(rng.uniform(-0.25, 0.25))
        wp += [
            [m + off, m + off],
            [m + off, span - m - off],
            [span - m - off, span - m - off],
            [span - m - off, m + off],
        ]
    wp.append([m + 0.5, m])
    return world, simulate_log(
        world, np.asarray(wp), sensor, step=step, seed=seed, **noise
    )


def splice_odom(a_odom: np.ndarray, b_odom: np.ndarray) -> np.ndarray:
    """Continue b's odometry RIGIDLY from a's last pose — the
    kidnapped-robot simulation splice: ground truth teleports between the
    two traversals while the odometry frame lies smoothly onward. A
    constant offset would NOT do this (adding a theta offset without
    rotating the displacements corrupts b's own motion deltas)."""
    from slam2d_tpu_torch.run.frontend_tiled import _np_between, _np_compose

    anchor = np.asarray(a_odom[-1], np.float32)
    b0 = np.asarray(b_odom[0], np.float32)
    return np.stack(
        [_np_compose(anchor, _np_between(b0, bk)) for bk in b_odom]
    ).astype(np.float32)


def default_log(sensor: SensorConfig | None = None, step: float = 0.1,
                seed: int = 0):
    """A ~20x20 m loopy trajectory through the box-rooms world: (world,
    log), the CLI's `--log synth`."""
    sensor = sensor or SensorConfig()
    world = SynthWorld.box_rooms(20.0)
    wp = np.asarray(
        [
            [3.0, 3.0], [3.0, 8.0], [8.0, 8.0], [12.0, 3.5], [17.0, 3.5],
            [17.0, 9.0], [12.0, 14.0], [16.0, 17.0], [9.0, 17.0],
            [4.0, 16.0], [3.0, 10.0], [3.0, 3.5],
        ]
    )
    return world, simulate_log(world, wp, sensor, step=step, seed=seed)
