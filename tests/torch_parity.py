"""Shared inputs of the PyTorch-port parity tests (tests/test_torch_*.py).

Every input is made with numpy from a seed and handed to both the JAX
package (on the CPU, as tests/conftest.py forces) and the port. Configs
are written as the JAX package's dataclasses; `to_port` rebuilds one as
the port's own (slam2d_tpu_torch/config.py) for the port's functions.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

import slam2d_tpu_torch.config as port_config
from slam2d_tpu.config import (
    FrontendConfig,
    GridConfig,
    MatcherConfig,
    PFConfig,
    SensorConfig,
)
from slam2d_tpu.data.synth import SynthWorld, simulate_log

SENSOR = SensorConfig(n_beams=180, max_range=12.0)


def to_port(cfg):
    """The port's config dataclass of the same name as the JAX config
    `cfg`, field by field, recursing into nested configs."""
    cls = getattr(port_config, type(cfg).__name__)
    return cls(**{
        f.name: (
            to_port(v) if dataclasses.is_dataclass(v) else v
        )
        for f in dataclasses.fields(cfg)
        for v in (getattr(cfg, f.name),)
    })


def to_jax(cfg):
    """The JAX package's config dataclass of the same name as the port's
    config `cfg`: `to_port` the other way."""
    import slam2d_tpu.config as jax_config

    cls = getattr(jax_config, type(cfg).__name__)
    return cls(**{
        f.name: (
            to_jax(v) if dataclasses.is_dataclass(v) else v
        )
        for f in dataclasses.fields(cfg)
        for v in (getattr(cfg, f.name),)
    })


def frontend_cfg(size: int = 256, chunk: int = 16,
                 update_impl: str = "pallas_hybrid") -> FrontendConfig:
    """tests/test_frontend_e2e.py's config with the hybrid map update, the
    update the JAX frontend runs on its accelerator: 256^2 runs unwindowed,
    512^2 runs a 288^2 scan window and a 272^2 update window."""
    return FrontendConfig(
        sensor=SENSOR,
        grid=GridConfig(
            height=size, width=size, resolution=0.1, ray_samples=128,
            center_x=10.0, center_y=10.0, update_impl=update_impl,
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


# ---- the particle filter's parity config (P = 8, short runs) ------------
#
# a 224^2 map at 0.1 m, a 120-beam 8 m sensor, float32 maps, the ISM map
# update, on 48 scans of a synthetic log
PF_SENSOR = SensorConfig(n_beams=120, max_range=8.0)
PF_CFG = FrontendConfig(
    sensor=PF_SENSOR,
    matcher=MatcherConfig(search_xy=0.25, search_theta=0.12, n_theta=9),
    grid=GridConfig(
        height=224, width=224, resolution=0.1, center_x=8.0, center_y=8.0,
        update_impl="pallas",
    ),
    chunk=8, bootstrap_dist=1.0,
)
PF_P = 8
PF_T = 48           # a multiple of PF_CFG.chunk: JAX's run loop pads no tail


@functools.cache
def pf_log():
    """The particle filter's parity log: PF_T scans of a noisy route
    through a 16 m box-rooms world."""
    world = SynthWorld.box_rooms(16.0)
    wp = np.array([[3.0, 3.0], [3.0, 9.0], [9.0, 9.0], [11.0, 4.0]])
    log = simulate_log(
        world, wp, PF_SENSOR, step=0.12, odom_noise_xy=0.03,
        odom_noise_theta=0.012, seed=11,
    )
    return {k: np.asarray(v)[:PF_T] for k, v in log.items()}


def pf_draws(rng, n, P=PF_P):
    """JAX's draws for n scans from key `rng`, as its fastslam_step splits
    it: standard normal noise [n, P, 3] and uniforms [n]."""
    import jax

    noise, us = [], []
    for _ in range(n):
        rng, k_noise, k_resample = jax.random.split(rng, 3)
        noise.append(np.asarray(jax.random.normal(k_noise, (P, 3))))
        us.append(np.asarray(jax.random.uniform(k_resample)))
    return np.stack(noise), np.stack(us).astype(np.float32)


def pf_run_pair(pf: PFConfig, cfg: FrontendConfig = PF_CFG, log=None):
    """The JAX filter and the port's (on the CPU, with JAX's draws) over
    the same log: ((traj, n_eff, scores) of JAX, of the port, port's final
    state)."""
    import jax
    import torch

    from slam2d_tpu.run.fastslam_run import run_fastslam as jax_run
    from slam2d_tpu_torch.run.fastslam_run import run_fastslam

    log = pf_log() if log is None else log
    _, ref_traj, ref_neff, ref_scores = jax_run(log, cfg, pf, seed=0)
    draws = pf_draws(jax.random.PRNGKey(0), len(log["odom"]), pf.n_particles)
    state, traj, n_eff, scores = run_fastslam(
        log, to_port(cfg), to_port(pf), torch.device("cpu"), draws=draws
    )
    return (ref_traj, ref_neff, ref_scores), (traj, n_eff, scores), state
