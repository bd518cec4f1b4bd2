"""The one generator of the benchmark's traffic: a robot session's log made
from a mix file (benchmark/traffic/<mix>.json) and the run's seed.

A mix holds parameters only:

- `world`: {"kind": "box_rooms", "size": metres} (the worlds of
  benchmark/synth.py);
- `route`: the waypoints [[x, y], ...] of one lap, driven `laps` times in
  a row;
- `step_m`: metres of travel between two scans;
- `odom_noise_xy`, `odom_noise_theta`, `range_noise`: the standard
  deviations of the odometry's noise a step and of a hit's range;
- `why`: one line on what the mix stands for.

The session's log is the laps' log cut to whole chunks of the
configuration's `chunk` scans, so that every chunk of a session is one
replay of the program's chunk graph. Every seed gives a log of the same
length along the same route: only the noise moves with the seed.
"""

from __future__ import annotations

import json
import math
import pathlib

import numpy as np

from benchmark import synth

ROOT = pathlib.Path(__file__).resolve().parent
WORLDS = {"box_rooms": synth.SynthWorld.box_rooms}


def load_mix(name: str, root: pathlib.Path = ROOT) -> dict:
    """The mix file benchmark/traffic/<name>.json."""
    return json.loads((root / "traffic" / f"{name}.json").read_text())


def beam_angles(sensor: dict) -> np.ndarray:
    """[B] float64 beam angles of a configuration's `sensor` block, as
    the program's SensorConfig.beam_angles builds them."""
    n = sensor["n_beams"]
    step = sensor["fov_rad"] / max(n - 1, 1)
    return sensor["angle_min"] + step * np.arange(n)


def lap_waypoints(mix: dict) -> np.ndarray:
    """The route's waypoints repeated `laps` times, [N, 2] float64."""
    route = [list(map(float, p)) for p in mix["route"]]
    return np.asarray(route * int(mix["laps"]), np.float64)


def session_log(mix: dict, sensor: dict, chunk: int, seed: int) -> dict:
    """The session's log {gt_poses, odom, ranges} (float32), cut to whole
    chunks of `chunk` scans."""
    world = WORLDS[mix["world"]["kind"]](float(mix["world"]["size"]))
    log = synth.simulate_log(
        world, lap_waypoints(mix), beam_angles(sensor),
        float(sensor["max_range"]), step=float(mix["step_m"]),
        odom_noise_xy=float(mix["odom_noise_xy"]),
        odom_noise_theta=float(mix["odom_noise_theta"]),
        range_noise=float(mix["range_noise"]), seed=seed,
    )
    T = len(log["odom"]) // chunk * chunk
    if T == 0:
        raise ValueError(f"the mix gives {len(log['odom'])} scans, fewer "
                         f"than one chunk of {chunk}")
    return {k: np.ascontiguousarray(v[:T]) for k, v in log.items()}


def route_length(mix: dict) -> float:
    """Metres of one pass over the laps' waypoints."""
    wp = lap_waypoints(mix)
    return float(sum(math.hypot(*(b - a)) for a, b in zip(wp[:-1], wp[1:])))
