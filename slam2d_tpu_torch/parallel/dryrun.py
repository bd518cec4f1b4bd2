"""The multi-device dry run, the twin of the JAX package's
`__graft_entry__.py:dryrun_multichip`: on every rank of a new world, at
its tiny shapes, one sharded FastSLAM step (propose, match, the weights
normalized over the ranks, map update, resample), the block-Schur solve
with its blocks split over the ranks, the edge-sharded matrix-free solve,
and a short run of the tiled frontend on the split tile pool. Rank 0
prints the tail line.

    python -m slam2d_tpu_torch.parallel.dryrun [N] [--backend gloo|nccl]
        [--device cpu|cuda|cuda:k]

The ranks run on the cards (rank r on cuda:(r % cards)) unless --device
names the CPU or one card. The backend defaults to the device's: nccl
when every rank has a card of its own, gloo on the CPU or when ranks
share a card (NCCL refuses two ranks on one card).
"""

from __future__ import annotations

import numpy as np
import torch

from slam2d_tpu_torch.config import (
    FrontendConfig,
    GraphConfig,
    GridConfig,
    MatcherConfig,
    PFConfig,
    SensorConfig,
)
from slam2d_tpu_torch.parallel import mesh as pmesh


def _rank(mesh: pmesh.Mesh) -> dict:
    from slam2d_tpu_torch.graph.schur import optimize_schur_sharded
    from slam2d_tpu_torch.graph.se2_graph import HostGraph
    from slam2d_tpu_torch.graph.sparse import optimize_cg_sharded
    from slam2d_tpu_torch.grid.tiles import TileConfig
    from slam2d_tpu_torch.pf.sharded import (
        sharded_fastslam_init,
        sharded_step,
    )
    from slam2d_tpu_torch.run.frontend_tiled_sharded import (
        run_sharded_tiled_frontend,
    )

    n = mesh.world_size
    dev = mesh.device
    cfg = FrontendConfig(
        sensor=SensorConfig(n_beams=32, max_range=8.0),
        grid=GridConfig(
            height=64, width=64, resolution=0.1, ray_samples=32,
            center_x=3.0, center_y=3.0,
        ),
        matcher=MatcherConfig(search_xy=0.2, search_theta=0.1, n_theta=5),
        bootstrap_dist=0.5,
    )
    pf = PFConfig(n_particles=2 * n)

    # one sharded FastSLAM step; JAX's ungated step runs every stage its
    # carry decides: on a fresh state that is the bootstrap's noisy
    # propagation and the map update
    state = sharded_fastslam_init(cfg, pf, mesh)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    odom = torch.tensor([0.1, 0.0, 0.0], device=dev)
    ranges = torch.full((cfg.sensor.n_beams,), 4.0, device=dev)
    state, (best_pose, n_eff, _, _) = sharded_step(
        state, odom, ranges, cfg, pf, mesh, gates=(False, True, True),
        generator=gen,
    )
    best_pose = best_pose.cpu().numpy()
    n_eff = float(n_eff)
    assert np.isfinite(best_pose).all()
    assert 1.0 - 1e-3 <= n_eff <= pf.n_particles + 1e-3

    # block-Schur elimination with the blocks over the ranks
    gcfg = GraphConfig(max_nodes=16, max_edges=32, gn_iters=3)
    host = HostGraph(gcfg)
    for k in range(8):
        host.add_node([float(k), 0.0, 0.0])
    for k in range(7):
        host.add_edge(k, k + 1, [1.0, 0.0, 0.0], np.eye(3) * 10.0)
    host.add_edge(7, 0, [-7.0, 0.0, 0.0], np.eye(3) * 10.0)
    g = host.to_device(dev)
    g2, chi = optimize_schur_sharded(g, gcfg, mesh, n_blocks=n)
    assert torch.isfinite(g2.poses[:8]).all()

    # the edge-sharded matrix-free solver
    g3, _ = optimize_cg_sharded(g, gcfg, mesh)
    assert torch.isfinite(g3.poses[:8]).all()

    # a short run of the tiled frontend on the split tile pool
    tcfg = TileConfig(tile=96, n_slots=16, resolution=0.1)
    tlog = {
        "odom": np.stack(
            [[0.1 * t, 0.0, 0.0] for t in range(8)]
        ).astype(np.float32),
        "ranges": np.full((8, cfg.sensor.n_beams), 4.0, np.float32),
    }
    tcfg_front = FrontendConfig(
        sensor=cfg.sensor, grid=cfg.grid, matcher=cfg.matcher, chunk=4,
        bootstrap_dist=0.5,
    )
    _, traj_t, _ = run_sharded_tiled_frontend(tlog, tcfg_front, tcfg,
                                              mesh=mesh)
    assert np.isfinite(traj_t).all()
    line = (
        f"dryrun_multichip({n}): ok — n_eff={n_eff:.2f}, "
        f"best_pose={best_pose}, schur_chi={float(chi):.4f}, "
        f"tiled_traj_end={traj_t[-1]}"
    )
    if mesh.rank == 0:
        print(line, flush=True)
    return {"line": line, "n_eff": n_eff, "best_pose": best_pose,
            "schur_poses": g2.poses[:8].cpu().numpy(),
            "cg_poses": g3.poses[:8].cpu().numpy(), "tiled_traj": traj_t,
            "staged_bytes": mesh.staged_bytes}


def default_backend(world_size: int, device=None) -> str:
    """The backend for `world_size` ranks on `device` (module docstring):
    gloo on the CPU or where ranks share a card, else nccl."""
    if device is not None and torch.device(device).type == "cpu":
        return "gloo"
    one_card = device is not None and torch.device(device).index is not None
    if one_card and world_size > 1:
        return "gloo"
    pmesh.rank_device(0, device)   # raises without a card
    return "nccl" if world_size <= torch.cuda.device_count() else "gloo"


def dryrun_multichip(world_size: int, backend: str | None = None,
                     device=None) -> list:
    """The dry run (module docstring) on a new world of `world_size`
    ranks (parallel/mesh.py's spawn, `device` as there; `backend` None
    takes default_backend's); returns each rank's results (its tail line
    under "line")."""
    if backend is None:
        backend = default_backend(world_size, device)
    return pmesh.spawn(_rank, world_size, backend, device)


def main(argv=None) -> list:
    """The command line (module docstring)."""
    import argparse

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("world_size", type=int, nargs="?", default=2)
    p.add_argument("--backend", default=None, choices=pmesh.BACKENDS)
    p.add_argument("--device", default=None)
    a = p.parse_args(argv)
    return dryrun_multichip(a.world_size, a.backend, a.device)


if __name__ == "__main__":
    main()
