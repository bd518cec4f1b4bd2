"""FastSLAM driver, port of slam2d_tpu/run/fastslam_run.py.

Two strategies, as the JAX package's, selected by `host_gated` (None:
host-gated iff n_particles >= PFConfig.host_gate_min_particles, the JAX
package's rule):

- HOST-GATED: the motion gates are pure functions of the odometry, which
  the host holds: `host_gate_flags` decides on the host which stages
  every scan runs, so the gates cost no device read, and each scan runs
  only its own stages (`fastslam_step(..., gates=row)`). A refine event
  reads one value back, the resample trigger.
- DEVICE-GATED (the JAX package's single `lax.scan` program with
  `lax.cond` gates, `make_pf_chunk_fn`): every scan runs
  `fastslam_step(..., gates=None)`, whose gates and resample trigger stay
  on the device. On CUDA a chunk of cfg.chunk scans is one CUDA graph
  (`PFChunkGraph`), replayed once a chunk: the host reads nothing a scan.
  On the CPU, and for a log's tail shorter than a chunk, the same steps
  run eagerly, scan by scan.

The log goes to the device once; the trajectory, N_eff and the scores stay
on the device until one fetch at the end.
"""

from __future__ import annotations

import numpy as np
import torch

from slam2d_tpu_torch.config import FrontendConfig, PFConfig
from slam2d_tpu_torch.ops.apply import shared_apply
from slam2d_tpu_torch.ops.corr import corr_scores
from slam2d_tpu_torch.ops.field import window_field
from slam2d_tpu_torch.ops.gather import gather_rows
from slam2d_tpu_torch.ops.refine_product import refine_product
from slam2d_tpu_torch.ops.score import score_window
from slam2d_tpu_torch.ops.stack import shift_stack
from slam2d_tpu_torch.ops.update import (
    update_hybrid_particles,
    update_ism,
    update_ray_particles,
)
from slam2d_tpu_torch.pf.fastslam import (
    PFState,
    fastslam_init,
    fastslam_step,
    host_gate_flags,
)
from slam2d_tpu_torch.run.capture import (
    ChunkCapture,
    chunk_graph_of,
    cuda_device,
    pinned,
)
from slam2d_tpu_torch.utils import profiling

# every kernel wrapper a FastSLAM step can launch (score_window: the
# per-particle refine with the gather scorer)
_KERNELS = (update_ism, update_hybrid_particles, update_ray_particles,
            window_field, shift_stack, refine_product, corr_scores,
            score_window, gather_rows, shared_apply)


class PFChunkGraph(ChunkCapture):
    """K device-gated FastSLAM steps of one config on one CUDA device,
    captured as one CUDA graph on static buffers: the seven PFState
    fields, odometry [K, 3], ranges [K, B], the draws (noise [K, P, 3], u
    [K]), the outputs [K, 5] (best pose, N_eff, best score), the
    (refines, updates, resamples) counters and the resample's scratch
    stack, a second [P, H, W] stack (the maps keep their address: the
    resample gathers into it and back, both launches gated). Built once
    per (cfg, pf, device, K) (`pf_chunk_graph`) by run/capture.py's
    ChunkCapture: warm-up steps on a side stream build the kernels and
    fill the caches, then `torch.cuda.graph` captures the K steps.

    A run `load`s its starting state into the static buffers once, then
    per chunk (`run_chunk(odom, ranges, noise, u, out)`): odometry and
    ranges copied from pinned host memory, the chunk's draws copied in on
    the device, one replay, one device copy of the outputs; `finish`
    clones the state out. Nothing is read back to the host. The kernels'
    launch counters count a capture's launches once a replay. A failed
    build or capture raises; nothing falls back to an eager or host-gated
    loop."""

    step = fastslam_step

    def __init__(self, cfg: FrontendConfig, pf: PFConfig, device, K: int):
        device = cuda_device(device)
        self.cfg, self.pf, self.device, self.K = cfg, pf, device, K
        P, H, W = pf.n_particles, cfg.grid.height, cfg.grid.width
        f32 = dict(dtype=torch.float32, device=device)
        self.state = PFState(
            torch.zeros((P, H, W), dtype=getattr(torch, pf.map_dtype),
                        device=device),
            torch.zeros((P, 3), **f32), torch.zeros(P, **f32),
            torch.zeros(3, **f32), torch.zeros((), **f32),
            torch.zeros((), **f32), torch.zeros((), **f32),
        )
        self.scratch = torch.empty_like(self.state.logodds)
        self.inputs = (
            torch.zeros((K, 3), **f32),
            torch.zeros((K, cfg.sensor.n_beams), **f32),
            torch.zeros((K, P, 3), **f32),
            torch.zeros(K, **f32),
        )
        self.out = torch.zeros((K, 5), **f32)
        self.counts = torch.zeros(3, dtype=torch.int64, device=device)
        syncs = fastslam_step.host_syncs
        self._capture(_KERNELS)
        if fastslam_step.host_syncs != syncs:
            raise RuntimeError("a captured FastSLAM step read the host")

    def _one(self, k, state):
        """Step k of the chunk from `state`, its outputs into out[k]."""
        odom, ranges, noise, u = self.inputs
        state, (pose, n_eff, score) = fastslam_step(
            state, odom[k], ranges[k], self.cfg, self.pf,
            noise=noise[k], u=u[k], counts=self.counts,
            scratch=self.scratch,
        )
        self.out[k, :3] = pose
        self.out[k, 3] = n_eff
        self.out[k, 4] = score
        return state

    def best_map(self) -> torch.Tensor:
        """A copy of the best-weighted particle's map (no host read)."""
        best = torch.argmax(self.state.log_w).reshape(1)
        return self.state.logodds.index_select(0, best)[0]


def pf_chunk_graph(cfg: FrontendConfig, pf: PFConfig, device,
                   K: int) -> PFChunkGraph:
    """The cached PFChunkGraph of (cfg, pf, device, K), built on first use:
    the counterpart of the JAX package's make_pf_chunk_fn."""
    return chunk_graph_of(PFChunkGraph, cfg, pf, torch.device(device), K)


def _run_host_gated(odom, ranges, cfg, pf, device, seed, state, draws,
                    frame_cb):
    """The host-gated strategy (module docstring)."""
    T = len(odom)
    if state is None:
        with profiling.span("session.init"):
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
    out = torch.empty((T, 5), dtype=torch.float32, device=device)
    for t in range(T):
        state, (bp, ne, sc) = fastslam_step(
            state, odom_d[t], ranges_d[t], cfg, pf, gates=flags[t],
            noise=None if draws is None else noise_d[t],
            u=None if draws is None else u_d[t],
            generator=generator,
        )
        out[t, :3] = bp
        out[t, 3] = ne
        out[t, 4] = sc
        if frame_cb is not None and ((t + 1) % cfg.chunk == 0 or t == T - 1):
            s0 = t - t % cfg.chunk
            best = int(torch.argmax(state.log_w))
            frame_cb(state.logodds[best], out[s0 : t + 1, :3].cpu().numpy())
    return state, out


def _run_device_gated(odom, ranges, cfg, pf, device, seed, state, draws,
                      frame_cb):
    """The device-gated strategy (module docstring): whole chunks as CUDA
    graph replays on CUDA, the rest eagerly."""
    T, K, P = len(odom), cfg.chunk, pf.n_particles
    if state is None:
        with profiling.span("session.init"):
            state = fastslam_init(cfg, pf, device, start_pose=odom[0])
    graphed = device.type == "cuda" and T >= K
    with profiling.span("call.stage"):
        if draws is None:
            generator = torch.Generator(device=device)
            generator.manual_seed(seed)
        else:
            noise_d = torch.as_tensor(draws[0], dtype=torch.float32,
                                      device=device)
            u_d = torch.as_tensor(draws[1], dtype=torch.float32,
                                  device=device)
        out = torch.empty((T, 5), dtype=torch.float32, device=device)
        if graphed:
            odom_p, ranges_p = pinned(odom), pinned(ranges)

    def chunk_draws(s, n):
        """The draws of scans [s, s + n): given, or a chunk's worth from
        the generator (noise, then u), as the graph and the eager loop
        both take them."""
        if draws is not None:
            return noise_d[s : s + n], u_d[s : s + n]
        return (torch.randn((n, P, 3), generator=generator, device=device),
                torch.rand(n, generator=generator, device=device))

    start = 0
    if graphed:
        start = T // K * K
        g = pf_chunk_graph(cfg, pf, device, K)
        g.load(state)
        for s in range(0, start, K):
            g.run_chunk(odom_p[s : s + K], ranges_p[s : s + K],
                        *chunk_draws(s, K), out[s : s + K])
            if frame_cb is not None:
                frame_cb(g.best_map(), out[s : s + K, :3].cpu().numpy())
        state = g.finish()
    if start < T:
        # staged only where a tail is left: each is a blocking copy, which
        # would wait for the replay before the driver's own read
        odom_d = torch.as_tensor(odom, device=device)
        ranges_d = torch.as_tensor(ranges, device=device)
    for s in range(start, T, K):
        n = min(K, T - s)
        with profiling.span("chunk.eager", scans=n):
            noise, u = chunk_draws(s, n)
            for k in range(n):
                state, (bp, ne, sc) = fastslam_step(
                    state, odom_d[s + k], ranges_d[s + k], cfg, pf,
                    noise=noise[k], u=u[k],
                )
                out[s + k, :3] = bp
                out[s + k, 3] = ne
                out[s + k, 4] = sc
        if frame_cb is not None:
            best = torch.argmax(state.log_w).reshape(1)
            frame_cb(state.logodds.index_select(0, best)[0],
                     out[s : s + n, :3].cpu().numpy())
    return state, out


def run_fastslam(
    log: dict, cfg: FrontendConfig, pf: PFConfig, device="cuda", seed: int = 0,
    state: PFState | None = None, draws=None, frame_cb=None,
    host_gated: bool | None = None,
):
    """Run the particle filter over a host-side log dict {odom, ranges}.

    Returns (final_state, best_traj [T, 3], n_eff [T], best_scores [T]),
    the last three as numpy arrays, fetched from the device in one copy.
    A fresh state starts every particle at odom[0]; a given `state` (e.g.
    from `pf_state_from_numpy`) is resumed (the host-gated strategy reads
    its gate accumulators back once). On "cuda" without a card it raises;
    nothing falls back to the CPU.

    `host_gated` picks the strategy (module docstring); None resolves as
    the JAX package does: host-gated iff pf.n_particles >=
    pf.host_gate_min_particles. Both give the same bits with the same
    draws. The device-gated strategy runs every whole chunk of cfg.chunk
    scans as one CUDA graph replay on CUDA, and the log's tail (and, on
    the CPU, every scan) eagerly through the same step; unlike the JAX
    package's chunked driver, no padded tail scans run, so the outputs are
    its first T rows and the final state is the one after scan T.

    `draws` = (noise [T, P, 3] standard normal, u [T] uniform), host
    arrays or tensors, replaces the draws of a `torch.Generator` seeded
    with `seed` on `device`. The host-gated strategy uses noise[t] if scan
    t refines or is in bootstrap and u[t] if it resamples, and draws from
    the generator only then; the device-gated one, as JAX's, takes noise
    and u at every scan, from the generator a chunk's worth at a time.

    `frame_cb(logodds, traj_chunk)` is called at every cfg.chunk-scan
    boundary (and after the last scan), as the JAX package's run loop calls
    it: the best-weighted particle's map ([H, W]; the host-gated loop
    passes a view of the state's tensor, valid until the next scan) and
    the chunk's best poses (numpy [n, 3]). The device-gated strategy reads
    the chunk's poses back, one read a chunk; the host-gated one also the
    weights.
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "run_fastslam: no CUDA device is available; pass device='cpu' "
            "to run on the CPU"
        )
    odom = np.asarray(log["odom"], np.float32)
    ranges = np.asarray(log["ranges"], np.float32)
    if host_gated is None:
        host_gated = pf.n_particles >= pf.host_gate_min_particles
    run = _run_host_gated if host_gated else _run_device_gated
    with profiling.call(state is None):
        state, out = run(odom, ranges, cfg, pf, device, seed, state, draws,
                         frame_cb)
        out = out.cpu().numpy()
    return state, out[:, :3].copy(), out[:, 3].copy(), out[:, 4].copy()
