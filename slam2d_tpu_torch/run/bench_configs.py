"""The configurations and synthetic logs of the JAX package's bench.py
(the frontend) and bench_pf.py (FastSLAM at its defaults, with 100, 1000
or 16 particles), a localization log and a kidnap log in bench.py's
world, the tiled frontend at the CLI's tile defaults on a lap of the
corridor world, full SLAM at the CLI's `--mode full` defaults on two
laps of bench.py's world, full SLAM on the tiled world at the CLI's
tile defaults on a Killian-scale lap of the corridor world, a 270-degree
scanner in bench.py's world, and the serpentine pose graph of
tests/test_sparse_graph.py (the sparse solvers' stress graph), for the
scripts that drive the port on a GPU (chip_smoke.py,
scripts/profile_torch.py), and the card's name and power limit as
nvidia-smi reports them.
"""

from __future__ import annotations

import dataclasses
import subprocess

import numpy as np

from slam2d_tpu_torch.config import (
    FrontendConfig,
    GraphConfig,
    GridConfig,
    MatcherConfig,
    PFConfig,
    SensorConfig,
)
from slam2d_tpu_torch.data.synth import (
    SynthWorld,
    corridor_loop_log,
    simulate_log,
    splice_odom,
)
from slam2d_tpu_torch.grid.tiles import TileConfig

LOG_SEED = 0
_ROUTE = [[3.0, 3.0], [3.0, 8.0], [8.0, 8.0], [12.0, 3.5], [16.0, 3.5],
          [17.0, 9.0], [12.0, 14.0], [9.0, 17.0], [4.0, 16.0], [3.0, 4.0]]


def bench_config():
    """bench.py's frontend config (chunk 64)."""
    return FrontendConfig(
        sensor=SensorConfig(n_beams=180, max_range=12.0),
        grid=GridConfig(
            height=1024, width=1024, resolution=0.05, ray_samples=256,
            center_x=10.0, center_y=10.0,
        ),
        matcher=MatcherConfig(search_xy=0.3, search_theta=0.15, n_theta=13),
        chunk=64,
        match_min_motion=0.25,
    )


def bench_log(sensor):
    """bench.py's synthetic log (seed 0, 0.05 m steps, 1078 scans)."""
    return simulate_log(
        SynthWorld.box_rooms(20.0), np.array(_ROUTE), sensor, step=0.05,
        seed=LOG_SEED,
    )


def pf_bench_config():
    """bench_pf.py's default config: FastSLAM-100 on bf16 512^2 maps."""
    cfg = FrontendConfig(
        sensor=SensorConfig(n_beams=180, max_range=12.0),
        grid=GridConfig(
            height=512, width=512, resolution=0.1, ray_samples=128,
            center_x=10.0, center_y=10.0,
        ),
        matcher=MatcherConfig(search_xy=0.25, search_theta=0.12, n_theta=9),
        chunk=32,
        bootstrap_dist=2.0,
    )
    pf = PFConfig(
        n_particles=100, map_dtype="bfloat16", noise_xy=0.01,
        noise_theta=0.005,
    )
    return cfg, pf


def pf1000_bench_config():
    """`bench_pf.py --particles 1000`, every other flag at its default:
    FastSLAM-1000, where update_mode "auto" resolves to the shared update
    (kernel 8) and refine_mode "auto" to the shared refine."""
    cfg, pf = pf_bench_config()
    return cfg, dataclasses.replace(pf, n_particles=1000)


def pf_per_particle_bench_config():
    """`bench_pf.py --particles 16`: below refine_shared_min_particles, so
    refine_mode "auto" resolves to the per-particle refine (kernel 5; one
    fine bilinear pass, as round(0.25 / 0.1) <= coarse_factor)."""
    cfg, pf = pf_bench_config()
    return cfg, dataclasses.replace(pf, n_particles=16)


def ray_bench_config():
    """bench.py's frontend config with update_impl="pallas_ray" (the
    exact-ray update, kernel 1 variant "ray", on its 520^2 window)."""
    cfg = bench_config()
    return dataclasses.replace(
        cfg, grid=dataclasses.replace(cfg.grid, update_impl="pallas_ray")
    )


def pf_bench_log(sensor):
    """bench_pf.py's synthetic log (seed 0, 0.05 m steps, 653 scans): the
    first seven waypoints of bench.py's route."""
    return simulate_log(
        SynthWorld.box_rooms(20.0), np.array(_ROUTE[:7]), sensor, step=0.05,
        seed=LOG_SEED,
    )


def localization_log(sensor):
    """A second traversal of bench.py's world for localization on the map
    of bench_log: its route reversed, with twice bench_log's odometry
    noise (seed 9), as tests/test_localize.py makes its second traversal
    noisier than the mapping one."""
    return simulate_log(
        SynthWorld.box_rooms(20.0), np.array(_ROUTE[::-1]), sensor,
        step=0.05, odom_noise_xy=0.008, odom_noise_theta=0.004, seed=9,
    )


def kidnap_log(sensor):
    """A kidnapped robot in bench.py's world at its step (0.05 m): two
    traversals whose odometry is spliced so that it lies smoothly onward
    while the ground truth teleports, built as tests/test_localize.py
    builds its kidnap log (`test_recovery_after_kidnap`), at bench.py's
    step and sensor. The second traversal runs on along bench.py's route
    ((9, 17), (4, 16)): at 0.05 m steps and 64-scan chunks the test's
    route gives it 3.6 chunks, too few for the two lost chunks recovery
    waits for and a tracked stretch after them (609 scans in all)."""
    world = SynthWorld.box_rooms(20.0)
    a = simulate_log(world, np.array([[3.0, 3.0], [3.0, 8.0], [7.0, 8.0]]),
                     sensor, step=0.05, seed=3)
    b = simulate_log(world, np.array([[16.0, 3.5], [16.5, 8.5], [12.5, 13.5],
                                      [9.0, 17.0], [4.0, 16.0]]),
                     sensor, step=0.05, seed=4)
    return {
        "odom": np.concatenate([a["odom"], splice_odom(a["odom"], b["odom"])]),
        "ranges": np.concatenate([a["ranges"], b["ranges"]]),
        "gt_poses": np.concatenate([a["gt_poses"], b["gt_poses"]]),
    }


def tiled_bench_config():
    """(cfg, tcfg): the CLI's tiled defaults, TileConfig(tile=512,
    n_slots=64, resolution=0.05), with bench.py's sensor (180 beams, 12 m),
    matcher and chunk 64 (cfg.grid lends only its log-odds constants)."""
    return bench_config(), TileConfig(tile=512, n_slots=64, resolution=0.05)


def tiled_bench_log(sensor):
    """A lap of the 60 m ring corridor (corridor_loop_log, 0.05 m steps,
    seed 3): ~228 m of travel, 4,551 scans."""
    _, log = corridor_loop_log(sensor, span=60.0, step=0.05, seed=3)
    return log


def fullslam_bench_config():
    """(cfg, graph_cfg): full SLAM as the CLI's `--mode full` runs it by
    default, bench.py's frontend config (1024^2 at 0.05 m, 180 beams,
    n_theta 13, chunk 64) with the JAX package's
    scripts/bench_fullslam.py graph settings (512 nodes, 2048 edges,
    keyframes every 1 m, loop gap 20, radius 3 m, accept score 0.35,
    corrections up to 2.5 m, 10 Gauss-Newton iterations)."""
    return bench_config(), GraphConfig(
        max_nodes=512, max_edges=2048, keyframe_dist=1.0, loop_min_gap=20,
        loop_radius=3.0, loop_score_accept=0.35, loop_max_correction_xy=2.5,
        gn_iters=10,
    )


def fullslam_bench_log(sensor, seed: int = 3):
    """scripts/bench_fullslam.py's log: two laps of bench.py's box-rooms
    tour (0.15 m steps, odometry noise 0.02 m / 0.006 rad, seed 3), the
    second lap re-entering the first's territory throughout: 715 scans.
    Another `seed` draws other noise along the same route."""
    lap = _ROUTE[:-1] + [[3.0, 10.0]]
    wp = np.array(lap + [[3.0, 3.5]] + lap[1:] + [[3.0, 4.0]])
    return simulate_log(
        SynthWorld.box_rooms(20.0), wp, sensor, step=0.15,
        odom_noise_xy=0.02, odom_noise_theta=0.006, seed=seed,
    )


def fullslam_tiled_bench_config():
    """(cfg, tcfg, graph_cfg): full SLAM on the tiled world at the CLI's
    tile defaults (tiled_bench_config: 512^2 tiles, 64 slots, 0.05 m,
    bench.py's sensor, matcher and chunk 64) with fullslam_bench_config's
    GraphConfig."""
    cfg, tcfg = tiled_bench_config()
    return cfg, tcfg, fullslam_bench_config()[1]


def fullslam_tiled_killian_config():
    """(cfg, tcfg, graph_cfg) of tests/test_killian_scale.py: 256^2 tiles
    at 0.1 m (48 slots), bench.py's sensor, the test's matcher (n_theta
    13, search_xy 0.3 m) and chunk 32, keyframes every 1 m, loop radius
    3 m, gap 20, accept score 0.35. On fullslam_tiled_bench_log it closes
    the lap (the JAX package's test holds kf ATE below 2 m)."""
    cfg = FrontendConfig(
        sensor=SensorConfig(n_beams=180, max_range=12.0),
        grid=GridConfig(resolution=0.1, ray_samples=128),
        matcher=MatcherConfig(search_xy=0.3, search_theta=0.15, n_theta=13),
        chunk=32,
        bootstrap_dist=2.0,
    )
    gcfg = GraphConfig(
        max_nodes=512, max_edges=2048, keyframe_dist=1.0, loop_min_gap=20,
        loop_radius=3.0, loop_score_accept=0.35, gn_iters=10,
    )
    return cfg, TileConfig(tile=256, n_slots=48, resolution=0.1), gcfg


def fullslam_tiled_bench_log(sensor, seed: int = 3):
    """tests/test_killian_scale.py's lap: the 60 m ring corridor at 0.25 m
    steps, odometry noise 0.02 m / 0.004 rad, seed 3 (911 scans, ~230 m
    of travel, odometry drifting more than 5 m). Another `seed` draws
    other noise over the same ground truth."""
    _, log = corridor_loop_log(sensor, span=60.0, step=0.25,
                               odom_noise_xy=0.02, odom_noise_theta=0.004,
                               seed=seed)
    return log


def wide_fov_config():
    """bench.py's frontend config (1024^2 at 0.05 m, its matcher and chunk
    64) with a Hokuyo UTM-30LX's published geometry: 1081 beams over
    270 degrees (0.25 degree steps), 0.1-30 m, over bench_log's route.
    update_impl "auto" resolves to the sampled-ray update at a field of
    view past pi."""
    cfg = bench_config()
    fov = 1.5 * np.pi
    sensor = SensorConfig(n_beams=1081, fov_rad=fov, angle_min=-0.5 * fov,
                          min_range=0.1, max_range=30.0)
    return dataclasses.replace(cfg, sensor=sensor)


def serpentine_graph_arrays(K: int, n_loops: int, seed: int = 0,
                            drift: float = 0.02):
    """tests/test_sparse_graph.py's `_serpentine_graph` in numpy: a K-node
    serpentine corridor sweep (passes of 64 nodes joined by u-turn rungs),
    odometry with `drift` noise, and n_loops rung closures between
    adjacent passes. Returns (arrays, gt [K, 3], est [K, 3], GraphConfig
    kwargs): `arrays` holds the PoseGraph fields (poses, node_mask,
    n_nodes, edges_ij, edges_z, edges_omega, edge_mask, n_edges) as numpy
    arrays and ints."""
    rng = np.random.default_rng(seed)
    cfg = dict(max_nodes=K, max_edges=K + n_loops + 8, gn_iters=6)
    leg = 64
    gt = np.zeros((K, 3))
    true_d = np.zeros((K - 1, 3))
    for k in range(1, K):
        _, s = divmod(k, leg)
        true_d[k - 1] = [0.0, 1.0, np.pi] if s == 0 else [1.0, 0.0, 0.0]
        p = gt[k - 1]
        c, si = np.cos(p[2]), np.sin(p[2])
        d = true_d[k - 1]
        gt[k] = [p[0] + c * d[0] - si * d[1], p[1] + si * d[0] + c * d[1],
                 (p[2] + d[2] + np.pi) % (2 * np.pi) - np.pi]
    est = np.zeros_like(gt)
    est[0] = gt[0]
    for k in range(1, K):
        dn = true_d[k - 1] + rng.normal(0, drift, 3) * [1, 1, 0.3]
        p = est[k - 1]
        c, si = np.cos(p[2]), np.sin(p[2])
        est[k] = [p[0] + c * dn[0] - si * dn[1], p[1] + si * dn[0] + c * dn[1],
                  (p[2] + dn[2] + np.pi) % (2 * np.pi) - np.pi]

    E = cfg["max_edges"]
    edges_ij = np.zeros((E, 2), np.int32)
    edges_z = np.zeros((E, 3), np.float32)
    omegas = np.zeros((E, 3, 3), np.float32)
    emask = np.zeros(E, bool)
    edges_ij[: K - 1] = np.stack([np.arange(K - 1), np.arange(1, K)], 1)
    edges_z[: K - 1] = true_d
    omegas[: K - 1] = np.eye(3) * 100.0

    def rel(a, b):
        d = gt[b] - gt[a]
        c, si = np.cos(gt[a][2]), np.sin(gt[a][2])
        return np.array([c * d[0] + si * d[1], -si * d[0] + c * d[1],
                         (gt[b][2] - gt[a][2] + np.pi) % (2 * np.pi) - np.pi])

    n_pass = K // leg
    for li in range(n_loops):
        pass_i = 1 + (li % max(1, n_pass - 1))
        s = int(rng.integers(4, leg - 4))
        a = (pass_i - 1) * leg + s
        b = pass_i * leg + (leg - 1 - s)
        if b >= K:
            continue
        edges_ij[K - 1 + li] = (a, b)
        edges_z[K - 1 + li] = rel(a, b)
        omegas[K - 1 + li] = np.eye(3) * 400.0
    emask[: K - 1 + n_loops] = True
    arrays = dict(
        poses=est.astype(np.float32), node_mask=np.ones(K, bool), n_nodes=K,
        edges_ij=edges_ij, edges_z=edges_z, edges_omega=omegas,
        edge_mask=emask, n_edges=K - 1 + n_loops,
    )
    return arrays, gt, est, cfg


def hier_bench_graph(K: int):
    """The serpentine of tests/test_sparse_graph.py's 4096-node case
    scaled to K nodes: one rung closure per ~34 nodes (120 at 4096),
    odometry drift 0.01, the solver's loop capacity 128. Returns
    serpentine_graph_arrays' (arrays, gt, est, GraphConfig kwargs) with
    sparse_max_loops set: chip_smoke.py phase 19's graph and
    scripts/hier_reference.py's."""
    arrays, gt, est, cfg = serpentine_graph_arrays(
        K, int(round(K * 120 / 4096)), drift=0.01)
    return arrays, gt, est, dict(cfg, sparse_max_loops=128)


def card() -> str:
    """The first card's name and power limit, as `nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader` prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]
