"""FastSLAM with its particles split over the ranks of a mesh, port of
slam2d_tpu/run/sharded_run.py (BASELINE config 4): the host loop of
run/fastslam_run.py over pf/sharded.py's step, every rank running it.

The stage gates come from `host_gate_flags` on the host, the same on
every rank. Two forms, as in the JAX package: host-gated (scans where no
stage fires go through `sharded_light_chunk`, up to LIGHT_SEG a run, one
collective a run) and ungated (every scan through `sharded_step`); both
give the same bits. No collective is captured in a CUDA graph.
"""

from __future__ import annotations

import numpy as np
import torch

from slam2d_tpu_torch.config import FrontendConfig, PFConfig
from slam2d_tpu_torch.parallel import mesh as pmesh
from slam2d_tpu_torch.pf.fastslam import PFState, host_gate_flags
from slam2d_tpu_torch.pf.sharded import (
    _global_log_normalize,
    place_state,
    sharded_fastslam_init,
    sharded_light_chunk,
    sharded_step,
)

LIGHT_SEG = 16   # the longest dead-reckoning run of one collective


def run_sharded_fastslam(
    log: dict, cfg: FrontendConfig, pf: PFConfig, seed: int = 0,
    mesh: pmesh.Mesh | None = None, state: PFState | None = None,
    host_gated: bool | None = None, draws=None,
):
    """Run the sharded particle filter over a host-side log {odom, ranges}
    on every rank of `mesh` (default: the mesh this process joined).

    Returns (this rank's state block, best_traj [T, 3], n_eff [T],
    best_scores [T]), the last three numpy arrays, the same on every
    rank. A fresh state starts every particle at odom[0]; a given
    `state`, a whole one (P particles, e.g. a checkpoint), is resumed:
    placed rank by rank, its gate accumulators read back once. `host_gated` None
    takes the JAX package's default (host-gated from
    pf.host_gate_min_particles particles on). `draws` = (noise [T, P, 3],
    u [T]) replaces the draws of a torch.Generator seeded with `seed` on
    the mesh's device, which every rank draws whole and keeps its rows
    of, so a seed gives the single-device port's draws at any world
    size."""
    mesh = pmesh.current() if mesh is None else mesh
    dev = mesh.device
    odom = np.asarray(log["odom"], np.float32)
    ranges = np.asarray(log["ranges"], np.float32)
    T = len(odom)
    if state is None:
        state = sharded_fastslam_init(cfg, pf, mesh, start_pose=odom[0])
        dist0, su0, sm0, prev0 = 0.0, np.inf, 0.0, odom[0]
    else:
        state = place_state(state, mesh)
        sharded_step.host_syncs += 1
        packed = torch.cat([
            torch.stack([state.dist, state.since_update, state.since_match]),
            state.prev_odom,
        ]).cpu().numpy()
        dist0, su0, sm0, prev0 = packed[0], packed[1], packed[2], packed[3:]
    flags = host_gate_flags(odom, cfg, prev0, dist0, su0, sm0)
    if host_gated is None:
        host_gated = pf.n_particles >= pf.host_gate_min_particles

    odom_d = torch.as_tensor(odom, device=dev)
    ranges_d = torch.as_tensor(ranges, device=dev)
    generator = None
    if draws is None:
        generator = torch.Generator(device=dev)
        generator.manual_seed(seed)
    else:
        noise_d = torch.as_tensor(np.asarray(draws[0]), dtype=torch.float32,
                                  device=dev)
        u_d = torch.as_tensor(np.asarray(draws[1]), dtype=torch.float32,
                              device=dev)
    traj = torch.empty((T, 3), dtype=torch.float32, device=dev)
    n_eff = torch.empty(T, dtype=torch.float32, device=dev)
    scores = torch.full((T,), -1.0, dtype=torch.float32, device=dev)
    _, ne = _global_log_normalize(state.log_w, mesh)
    t = 0
    while t < T:
        if host_gated and not flags[t].any():
            n = 1
            while n < LIGHT_SEG and t + n < T and not flags[t + n].any():
                n += 1
            state, bp = sharded_light_chunk(state, odom_d[t : t + n], cfg,
                                            mesh)
            traj[t : t + n] = bp
            n_eff[t : t + n] = ne
            t += n
            continue
        state, (bp, ne_t, sc, ne) = sharded_step(
            state, odom_d[t], ranges_d[t], cfg, pf, mesh, gates=flags[t],
            n_eff=ne, noise=None if draws is None else noise_d[t],
            u=None if draws is None else u_d[t], generator=generator,
        )
        traj[t] = bp
        n_eff[t] = ne_t
        scores[t] = sc
        t += 1
    return (
        state, traj.cpu().numpy(), n_eff.cpu().numpy(), scores.cpu().numpy()
    )
