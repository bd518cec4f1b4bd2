"""Shared inputs of the PyTorch-port parity tests (tests/test_torch_*.py).

Every input is made with numpy from a seed and handed to both the JAX
package (on the CPU, as tests/conftest.py forces) and the port.
"""

from __future__ import annotations

import numpy as np

from slam2d_tpu.config import (
    FrontendConfig,
    GridConfig,
    MatcherConfig,
    SensorConfig,
)
from slam2d_tpu.data.synth import SynthWorld, simulate_log

SENSOR = SensorConfig(n_beams=180, max_range=12.0)


def frontend_cfg(size: int = 256, chunk: int = 16) -> FrontendConfig:
    """tests/test_frontend_e2e.py's config with the hybrid map update, the
    update the JAX frontend runs on its accelerator: 256^2 runs unwindowed,
    512^2 runs a 288^2 scan window and a 272^2 update window."""
    return FrontendConfig(
        sensor=SENSOR,
        grid=GridConfig(
            height=size, width=size, resolution=0.1, ray_samples=128,
            center_x=10.0, center_y=10.0, update_impl="pallas_hybrid",
        ),
        matcher=MatcherConfig(search_xy=0.3, search_theta=0.15, n_theta=13),
        chunk=chunk,
    )


def e2e_log():
    """tests/test_frontend_e2e.py's log (133 scans, drifting odometry)."""
    world = SynthWorld.box_rooms(20.0)
    wp = np.array(
        [[3.0, 3.0], [3.0, 8.0], [8.0, 8.0], [12.0, 3.5], [16.0, 3.5]]
    )
    return simulate_log(
        world, wp, SENSOR, step=0.15,
        odom_noise_xy=0.01, odom_noise_theta=0.004, seed=7,
    )


def synth_ranges(pose, sensor: SensorConfig = SENSOR) -> np.ndarray:
    """One float32 scan of the box-rooms world from world pose (x, y, th)."""
    world = SynthWorld.box_rooms(20.0)
    r = world.raycast(
        np.asarray(pose, np.float64), np.asarray(sensor.beam_angles()),
        sensor.max_range,
    )
    return np.asarray(r, np.float32)


def pose_error(a: np.ndarray, b: np.ndarray):
    """(max |dxy|, max |dtheta|) between two [..., 3] pose arrays."""
    dxy = np.hypot(a[..., 0] - b[..., 0], a[..., 1] - b[..., 1])
    dth = np.abs(np.angle(np.exp(1j * (a[..., 2] - b[..., 2]))))
    return float(np.max(dxy)), float(np.max(dth))
