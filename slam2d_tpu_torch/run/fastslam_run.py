"""FastSLAM driver, port of slam2d_tpu/run/fastslam_run.py.

The motion gates are pure functions of the odometry, which the host holds:
`host_gate_flags` decides on the host which stages every scan runs, so
the gates cost no device read, and each scan runs only its own stages
(`fastslam_step`). A refine event reads one value back, the resample
trigger. The log goes to the device once; the trajectory, N_eff and the
scores stay on the device until the end.
"""

from __future__ import annotations

import numpy as np
import torch

from slam2d_tpu_torch.config import FrontendConfig, PFConfig
from slam2d_tpu_torch.pf.fastslam import (
    PFState,
    fastslam_init,
    fastslam_step,
    host_gate_flags,
)


def run_fastslam(
    log: dict, cfg: FrontendConfig, pf: PFConfig, device="cuda", seed: int = 0,
    state: PFState | None = None, draws=None, frame_cb=None,
):
    """Run the particle filter over a host-side log dict {odom, ranges}.

    Returns (final_state, best_traj [T, 3], n_eff [T], best_scores [T]),
    the last three as numpy arrays. A fresh state starts every particle at
    odom[0]; a given `state` (e.g. from `pf_state_from_numpy`) is resumed,
    which reads its gate accumulators back once. `draws` = (noise [T, P, 3]
    standard normal, u [T] uniform), host arrays or tensors, replaces the
    draws of a `torch.Generator` seeded with `seed` on `device`: scan t
    uses noise[t] if it refines or is in bootstrap and u[t] if it
    resamples. Unlike the JAX package's chunked driver, no padded tail
    scans run, so the final state equals the JAX one when the log length
    is a multiple of cfg.chunk.

    `frame_cb(logodds, traj_chunk)` is called at every cfg.chunk-scan
    boundary (and after the last scan), as the JAX package's run loop calls
    it: the best-weighted particle's map (a view of the state's tensor,
    valid until the next scan) and the chunk's best poses (numpy [n, 3]);
    each call reads the weights and the chunk's poses back.
    """
    odom = np.asarray(log["odom"], np.float32)
    ranges = np.asarray(log["ranges"], np.float32)
    T = len(odom)
    if state is None:
        state = fastslam_init(cfg, pf, device, start_pose=odom[0])
        dist0, su0, sm0, prev0 = 0.0, np.inf, 0.0, odom[0]
    else:
        fastslam_step.host_syncs += 1
        packed = torch.cat([
            torch.stack([state.dist, state.since_update, state.since_match]),
            state.prev_odom,
        ]).cpu().numpy()
        dist0, su0, sm0, prev0 = packed[0], packed[1], packed[2], packed[3:]
    flags = host_gate_flags(odom, cfg, prev0, dist0, su0, sm0)

    odom_d = torch.as_tensor(odom, device=device)
    ranges_d = torch.as_tensor(ranges, device=device)
    generator = None
    if draws is None:
        generator = torch.Generator(device=device)
        generator.manual_seed(seed)
    else:
        noise_d = torch.as_tensor(draws[0], dtype=torch.float32, device=device)
        u_d = torch.as_tensor(draws[1], dtype=torch.float32, device=device)
    traj = torch.empty((T, 3), dtype=torch.float32, device=device)
    n_eff = torch.empty(T, dtype=torch.float32, device=device)
    scores = torch.empty(T, dtype=torch.float32, device=device)
    for t in range(T):
        state, (bp, ne, sc) = fastslam_step(
            state, odom_d[t], ranges_d[t], cfg, pf, gates=flags[t],
            noise=None if draws is None else noise_d[t],
            u=None if draws is None else u_d[t],
            generator=generator,
        )
        traj[t] = bp
        n_eff[t] = ne
        scores[t] = sc
        if frame_cb is not None and ((t + 1) % cfg.chunk == 0 or t == T - 1):
            s0 = t - t % cfg.chunk
            best = int(torch.argmax(state.log_w))
            frame_cb(state.logodds[best], traj[s0 : t + 1].cpu().numpy())
    return (
        state, traj.cpu().numpy(), n_eff.cpu().numpy(), scores.cpu().numpy()
    )
