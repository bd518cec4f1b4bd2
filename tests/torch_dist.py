"""Rank bodies of the port's multi-device tests (tests/test_torch_mesh.py,
test_torch_sharded_*.py, test_torch_tiles_sharded.py,
test_torch_frontend_tiled_sharded.py): each runs on every rank of a world
of gloo ranks on the CPU that parallel/mesh.py's `spawn` starts, takes
numpy inputs and returns numpy outputs. This module imports neither JAX
nor a test file, so a spawned rank imports only the port.
"""

from __future__ import annotations

import numpy as np
import torch

CPU = torch.device("cpu")


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def collectives(mesh, x):
    """Every collective of the mesh on rank r's row x[r]."""
    torch.set_num_threads(1)
    t = _t(x[mesh.rank])
    n = mesh.world_size
    out = {
        "stacked": mesh.all_gather(t).numpy(),
        "tiled": mesh.all_gather(t[None], tiled=True).numpy(),
        "psum": mesh.psum(t).numpy(),
        "pmax": mesh.pmax(t).numpy(),
        "ring": mesh.ppermute(t).numpy(),
        "ring2": mesh.ppermute(t, shift=2).numpy(),
        "ring_back": mesh.ppermute(t, shift=n - 1).numpy(),
        "bcast": mesh.broadcast(t, src=n - 1).numpy(),
        "gathered": mesh.gather_to(t, dst=0),
        "int_pmax": mesh.pmax(torch.tensor([mesh.rank * 3 % n])).numpy(),
    }
    buf = torch.empty_like(t)
    mesh.ppermute(t, out=buf)
    out["ring_out"] = buf.numpy()
    if out["gathered"] is not None:
        out["gathered"] = np.stack([g.numpy() for g in out["gathered"]])
    out["staged"] = mesh.staged_bytes
    return out


def raise_on_rank(mesh, bad: int):
    """Rank `bad` raises; the others wait in a collective."""
    if mesh.rank == bad:
        raise ValueError(f"rank {bad} fails on purpose")
    mesh.psum(torch.zeros(4))
    return mesh.rank


# ---- the particle filter ---------------------------------------------------

def _pf_state(arrays):
    from slam2d_tpu_torch.pf.fastslam import PFState

    return PFState(*(torch.as_tensor(np.asarray(arrays[f])).clone()
                     for f in PFState._fields))


def _whole(state, mesh):
    from slam2d_tpu_torch.pf.fastslam import pf_state_to_numpy
    from slam2d_tpu_torch.pf.sharded import gather_state

    whole = gather_state(state, mesh)
    return None if whole is None else pf_state_to_numpy(whole)._asdict()


def pf_step(mesh, cfg, pf, arrays, odom, ranges, gates, noise, u):
    """One sharded_step from the whole state `arrays` (PFState's fields);
    returns the whole state after it (rank 0) and the step's outputs."""
    from slam2d_tpu_torch.pf import sharded as sh

    torch.set_num_threads(1)
    state = sh.place_state(_pf_state(arrays), mesh)
    sh.ring_exchange.d_max.clear()
    state, (bp, ne, sc, carry) = sh.sharded_step(
        state, _t(odom), _t(ranges), cfg, pf, mesh, gates=gates,
        noise=_t(noise), u=_t(u),
    )
    return {"state": _whole(state, mesh), "best_pose": bp.numpy(),
            "n_eff": float(ne), "score": float(sc), "carry": float(carry),
            "d_max": list(sh.ring_exchange.d_max)}


def ring(mesh, maps, patterns):
    """ring_exchange of the whole [P, N] `maps` for each ancestor pattern
    [P]; returns the whole result of each (rank 0) and the d_max each."""
    from slam2d_tpu_torch.pf import sharded as sh

    torch.set_num_threads(1)
    P = maps.shape[0]
    Pl = P // mesh.world_size
    lo = mesh.rank * Pl
    outs, dmax = [], []
    for anc in patterns:
        sh.ring_exchange.d_max.clear()
        blk = _t(maps[lo : lo + Pl])
        got, k_need = sh.ring_exchange(
            blk, _t(anc[lo : lo + Pl], torch.int32), mesh)
        parts = mesh.gather_to(got)
        outs.append(None if parts is None else torch.cat(parts).numpy())
        dmax.append(sh.ring_exchange.d_max[0])
    return {"outs": outs, "d_max": dmax}


def pf_steps(mesh, cfg, pf, scenarios, maps, patterns):
    """pf_step for each (arrays, odom, ranges, gates, noise, u) of
    `scenarios`, then ring for the `patterns` over `maps`."""
    return ([pf_step(mesh, cfg, pf, *sc) for sc in scenarios],
            ring(mesh, maps, patterns))


def pf_runs(mesh, log, cfg, pf, seed):
    """pf_run host-gated and ungated, with the same seed."""
    return [pf_run(mesh, log, cfg, pf, seed, hg) for hg in (True, False)]


def pf_run(mesh, log, cfg, pf, seed=0, host_gated=None, draws=None):
    """run_sharded_fastslam; returns (traj, n_eff, scores), the counts and
    the whole final state (rank 0)."""
    from slam2d_tpu_torch.pf import sharded as sh
    from slam2d_tpu_torch.run.sharded_run import run_sharded_fastslam

    torch.set_num_threads(1)
    for name in ("host_syncs", "refines", "updates", "resamples"):
        setattr(sh.sharded_step, name, 0)
    sh.ring_exchange.d_max.clear()
    sh.ring_exchange.hops = 0
    state, traj, n_eff, scores = run_sharded_fastslam(
        log, cfg, pf, seed=seed, mesh=mesh, host_gated=host_gated,
        draws=draws,
    )
    return {"traj": traj, "n_eff": n_eff, "scores": scores,
            "resamples": sh.sharded_step.resamples,
            "d_max": list(sh.ring_exchange.d_max),
            "hops": sh.ring_exchange.hops,
            "local_maps": state.logodds.shape[0],
            "state": _whole(state, mesh)}


def pf_resume(mesh, log, cfg, pf, draws, cut, path):
    """The first `cut` scans, the state gathered to rank 0 and saved with
    utils/checkpoint, then loaded by every rank and placed again for the
    rest of the log. Returns the two halves' trajectories."""
    from slam2d_tpu_torch.pf.fastslam import pf_state_template
    from slam2d_tpu_torch.pf.sharded import gather_state
    from slam2d_tpu_torch.run.sharded_run import run_sharded_fastslam
    from slam2d_tpu_torch.utils.checkpoint import load_state, save_state

    torch.set_num_threads(1)
    first = {k: v[:cut] for k, v in log.items()}
    second = {k: v[cut:] for k, v in log.items()}
    noise, u = draws
    state, tr_a, ne_a, _ = run_sharded_fastslam(
        first, cfg, pf, mesh=mesh, draws=(noise[:cut], u[:cut]))
    whole = gather_state(state, mesh)
    if mesh.rank == 0:
        save_state(path, whole)
    mesh.barrier()
    restored = load_state(path, pf_state_template(cfg, pf), device=CPU)
    _, tr_b, ne_b, _ = run_sharded_fastslam(
        second, cfg, pf, mesh=mesh, state=restored,
        draws=(noise[cut:], u[cut:]))
    return {"traj": np.concatenate([tr_a, tr_b]),
            "n_eff": np.concatenate([ne_a, ne_b])}


# ---- tiles and the tiled frontend -----------------------------------------

def tile_ops(mesh, tcfg, needed, cases):
    """On pools split over the ranks with the tiles `needed` active: for
    each (window, origin) of `cases`, scatter the window, gather it back
    and gather a second window one tile away. Returns the gathered
    windows and the whole pool (rank 0)."""
    import dataclasses

    from slam2d_tpu_torch.grid.tiles import TiledGrid, TileTable
    from slam2d_tpu_torch.grid.tiles_sharded import (
        gather_region_sharded,
        scatter_region_sharded,
    )

    torch.set_num_threads(1)
    n = mesh.world_size
    n_pad = -(-tcfg.n_slots // n) * n
    table = TileTable(dataclasses.replace(tcfg, n_slots=n_pad))
    table.activate(TiledGrid(None, torch.from_numpy(table.coords.copy())),
                   needed)
    tiles = torch.zeros((n_pad // n, tcfg.tile, tcfg.tile))
    outs = []
    for window, origin in cases:
        w = _t(window)
        scatter_region_sharded(tiles, tcfg, w, origin, table, mesh)
        back = gather_region_sharded(tiles, tcfg, origin, w.shape[0], table,
                                     mesh)
        far = (origin[0] - tcfg.tile // 2, origin[1] + tcfg.tile)
        other = gather_region_sharded(tiles, tcfg, far, w.shape[0], table,
                                      mesh)
        outs.append((back.numpy(), other.numpy()))
    parts = mesh.gather_to(tiles)
    return {"outs": outs, "coords": table.coords.copy(),
            "pool": None if parts is None else torch.cat(parts).numpy(),
            "staged": mesh.staged_bytes}


def tiled_run(mesh, log, cfg, tcfg):
    """run_sharded_tiled_frontend; returns (traj, scores), the whole pools
    (rank 0) and this rank's tiles with content."""
    from slam2d_tpu_torch.run import frontend_tiled_sharded as fts

    torch.set_num_threads(1)
    state, traj, scores = fts.run_sharded_tiled_frontend(log, cfg, tcfg,
                                                         mesh=mesh)
    tiles = mesh.gather_to(state.tiles)
    stiles = mesh.gather_to(state.stiles)
    return {"traj": traj, "scores": scores,
            "coords": state.coords.numpy(),
            "tiles": None if tiles is None else torch.cat(tiles).numpy(),
            "stiles": None if stiles is None else torch.cat(stiles).numpy(),
            "local_with_content": int(
                (state.tiles.abs().sum((1, 2)) > 0).sum())}


# ---- the pose-graph solvers and full SLAM -----------------------------------

def _graph(arrays):
    from slam2d_tpu_torch.graph.se2_graph import PoseGraph

    return PoseGraph(*(torch.as_tensor(np.asarray(arrays[f]))
                       for f in PoseGraph._fields))


def solvers(mesh, gcfg, arrays, n_blocks):
    """The three sharded solvers on the graph `arrays` (PoseGraph's
    fields): edge-sharded dense, Schur with n_blocks blocks, the
    edge-sharded CG. Returns each one's (poses, chi2)."""
    from slam2d_tpu_torch.graph.schur import optimize_schur_sharded
    from slam2d_tpu_torch.graph.se2_graph import make_optimize_sharded
    from slam2d_tpu_torch.graph.sparse import optimize_cg_sharded

    torch.set_num_threads(1)
    g = _graph(arrays)
    out = {}
    for name, solve in (
        ("dense", lambda: make_optimize_sharded(gcfg, mesh)(g)),
        ("schur", lambda: optimize_schur_sharded(g, gcfg, mesh, n_blocks)),
        ("cg", lambda: optimize_cg_sharded(g, gcfg, mesh)),
    ):
        g2, chi = solve()
        out[name] = (g2.poses.numpy(), float(chi))
    return out


def full_slam(mesh, log, cfg, gcfg, optimizer):
    """run_full_slam with `optimizer` on every rank; returns its result's
    arrays."""
    from slam2d_tpu_torch.run.full_slam import run_full_slam

    torch.set_num_threads(1)
    res = run_full_slam(log, cfg, gcfg, optimizer=optimizer, device=CPU,
                        mesh=mesh)
    return {"traj": res.traj, "kf_poses": np.asarray(res.kf_poses),
            "kf_scan_idx": np.asarray(res.kf_scan_idx),
            "n_loops": res.n_loops, "chi2": res.chi2}


def full_slam_tiled(mesh, log, cfg, tcfg, gcfg, optimizer):
    """run_full_slam_tiled with `optimizer` on every rank."""
    from slam2d_tpu_torch.run.full_slam_tiled import run_full_slam_tiled

    torch.set_num_threads(1)
    res = run_full_slam_tiled(log, cfg, tcfg, gcfg, optimizer=optimizer,
                              device=CPU, mesh=mesh)
    return {"traj": res.traj, "kf_poses": np.asarray(res.kf_poses),
            "kf_scan_idx": np.asarray(res.kf_scan_idx),
            "n_loops": res.n_loops, "chi2": res.chi2}


def diverged_graph(mesh, gcfg):
    """Every rank holds a graph; rank 1's has one more node. Runs full
    SLAM's agreement before a sharded solve (it raises on rank 1)."""
    from slam2d_tpu_torch.graph.se2_graph import HostGraph
    from slam2d_tpu_torch.run.full_slam import agree_graph

    torch.set_num_threads(1)
    host = HostGraph(gcfg)
    for k in range(3 + (mesh.rank == 1)):
        host.add_node([float(k), 0.0, 0.0])
    agree_graph(host, mesh)
    return mesh.rank


def cli_rank(mesh, argv):
    """One rank of the CLI's sharded run (run/cli.py's rank body)."""
    from slam2d_tpu_torch.run import cli

    torch.set_num_threads(1)
    return cli._rank_main(mesh, argv)
