"""PyTorch port: full SLAM on the tiled world (run/full_slam_tiled.py)
against the JAX package's, on tests/test_full_slam_tiled.py's config and
log (128^2 tiles at 0.1 m, 120 beams, chunk 16, seed 5) with the hybrid
map update (the JAX update kernel in interpret mode; CPU), under the
dense and the Schur solvers.

Held equal: keyframe scan indices, the (i, j, accepted) columns of every
loop attempt, n_loops, the loop records' (i, j), the tile coords of
every slot. Tolerances (those of tests/test_torch_full_slam.py): poses
(keyframes, trajectory) 5e-3 m / 5e-3 rad (measured ~2e-5), chi2 1e-3
relative, the stitched log-odds pools at most 0.05% of cells off (each
by one l_free or l_occ, the hybrid update's), attempt scores and margins
1e-4. The tiled rebuilders are held bit-exact against each other; the
from-scratch rebuild against the JAX package's: the log-odds pool as
the maps above, the search-space pool (whose padded slots' windows are
written too) within 1e-6 outside the blur's reach of the log-odds cells
that differ (measured 1.8e-7: the blur's summation order) and at most
0.5% of its cells off by more than 1e-5 (tests/test_torch_frontend_tiled
.py's). The split run to the JAX package's own resume tolerances
(tests/test_resume.py: 1e-3).
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import binary_dilation

from slam2d_tpu.config import (
    FrontendConfig,
    GraphConfig,
    GridConfig,
    MatcherConfig,
    SensorConfig,
)
from slam2d_tpu.data.synth import SynthWorld, simulate_log
from slam2d_tpu.grid import tiles as jtiles
from slam2d_tpu.metrics import ate_rmse
from slam2d_tpu.run import full_slam_tiled as jfst
from slam2d_tpu_torch.grid import tiles as ttiles
from slam2d_tpu_torch.grid.window import blur_halo_cells
from slam2d_tpu_torch.run import full_slam_tiled as tfst
from test_incremental_rebuild import _keyframes
from torch_parity import pose_error, to_port

torch.set_num_threads(1)

CPU = torch.device("cpu")
POSE_TOL = 5e-3
SCORE_TOL = 1e-4
MAP_CELL_SHARE = 0.0005
S_CELL_SHARE = 0.005

CFG = FrontendConfig(
    sensor=SensorConfig(n_beams=120, max_range=12.0),
    grid=GridConfig(resolution=0.1, ray_samples=128,
                    update_impl="pallas_hybrid"),  # kernel params
    matcher=MatcherConfig(search_xy=0.3, search_theta=0.15, n_theta=13),
    chunk=16,
    bootstrap_dist=2.0,
)
JTCFG = jtiles.TileConfig(tile=128, n_slots=32, resolution=0.1)
TTCFG = ttiles.TileConfig(tile=128, n_slots=32, resolution=0.1)
GCFG = GraphConfig(
    max_nodes=128, max_edges=512, keyframe_dist=0.5,
    loop_min_gap=10, loop_radius=2.5, loop_score_accept=0.35,
    gn_iters=10,
)


@functools.cache
def _log():
    wp = np.array(
        [[3.0, 3.0], [3.0, 8.0], [8.0, 8.0], [12.0, 3.5], [16.0, 3.5],
         [17.0, 9.0], [12.0, 14.0], [9.0, 17.0], [4.0, 16.0], [3.0, 10.0],
         [3.0, 3.8]]
    )
    return simulate_log(
        SynthWorld.box_rooms(20.0), wp, CFG.sensor, step=0.15,
        odom_noise_xy=0.02, odom_noise_theta=0.008, seed=5,
    )


@functools.cache
def _jax_runs():
    """The JAX package's runs, both made before any of the port's: its
    Schur run at this config gives NaN poses when the process has first
    run JAX's dense one and then the port's (not alone after either)."""
    return {opt: jfst.run_full_slam_tiled(_log(), CFG, JTCFG, _gcfg(opt),
                                          optimizer=opt)
            for opt in ("dense", "schur", "hier")}


def _gcfg(optimizer):
    """GCFG; for "hier" with tests/test_full_slam.py's hier settings and
    hier_dense_max below the 128 slots, so that every solve runs the
    V-cycle and the PCG polish (the tiled runner shares the bounded one's
    dispatch)."""
    if optimizer != "hier":
        return GCFG
    return dataclasses.replace(GCFG, sparse_max_loops=16,
                               sparse_coarse_stride=8, hier_dense_max=64)


@functools.cache
def _runs(optimizer):
    ref = _jax_runs()[optimizer]
    out = tfst.run_full_slam_tiled(_log(), to_port(CFG), TTCFG,
                                   to_port(_gcfg(optimizer)),
                                   optimizer=optimizer, device=CPU)
    return ref, out


def _stitched(tiles, coords):
    grid = ttiles.TiledGrid(torch.tensor(np.array(tiles)),
                            torch.tensor(np.array(coords)))
    return ttiles.stitch_tiles(grid, TTCFG)[0]


@pytest.mark.parametrize("optimizer", ["dense", "schur", "hier"])
def test_run_full_slam_tiled_matches_jax(optimizer):
    ref, out = _runs(optimizer)
    log = _log()
    np.testing.assert_array_equal(out.kf_scan_idx, ref.kf_scan_idx)
    assert out.n_loops == ref.n_loops >= 1
    assert out.loop_attempts.shape == ref.loop_attempts.shape
    np.testing.assert_array_equal(out.loop_attempts[:, [0, 1, 6]],
                                  ref.loop_attempts[:, [0, 1, 6]])
    np.testing.assert_allclose(out.loop_attempts[:, 2:4],
                               ref.loop_attempts[:, 2:4], rtol=0,
                               atol=SCORE_TOL)
    np.testing.assert_array_equal(out.loops[:, :2], ref.loops[:, :2])
    for name, a, b in (("keyframes", out.kf_poses, ref.kf_poses),
                       ("trajectory", out.traj, ref.traj)):
        dxy, dth = pose_error(a, b)
        print(f"{name}: max |dxy| {dxy:.3g} m, max |dtheta| {dth:.3g} rad")
        assert dxy <= POSE_TOL and dth <= POSE_TOL
    np.testing.assert_allclose(out.chi2, ref.chi2, rtol=1e-3)
    np.testing.assert_array_equal(out.grid.coords.numpy(),
                                  np.asarray(ref.grid.coords))
    a = _stitched(out.grid.tiles, out.grid.coords)
    b = _stitched(ref.grid.tiles, ref.grid.coords)
    off = float((a != b).mean())
    print(f"stitched log-odds: {off:.3g} of cells differ")
    assert a.shape == b.shape and off <= MAP_CELL_SHARE
    # the scenario's own checks (tests/test_full_slam_tiled.py)
    gt = log["gt_poses"][out.kf_scan_idx]
    ate_kf = ate_rmse(out.kf_poses, gt, align=False)
    ate_odom = ate_rmse(log["odom"][out.kf_scan_idx], gt, align=False)
    print(f"kf ATE port {ate_kf:.5f} JAX "
          f"{ate_rmse(ref.kf_poses, gt, align=False):.5f} odometry "
          f"{ate_odom:.5f}")
    assert len(out.kf_poses) > 20 and np.isfinite(out.traj).all()
    assert ate_kf < ate_odom and ate_kf < 0.35


def _rebuild_cfg():
    """tests/test_incremental_rebuild.py's config, the hybrid update."""
    return FrontendConfig(
        sensor=SensorConfig(n_beams=60, max_range=10.0),
        grid=GridConfig(height=192, width=192, resolution=0.1,
                        ray_samples=96, center_x=6.0, center_y=6.0,
                        update_impl="pallas_hybrid"),
        matcher=MatcherConfig(search_xy=0.25, search_theta=0.12, n_theta=9),
    )


def _pad(capacity, poses, scans):
    pb = np.zeros((capacity, 3), np.float32)
    sb = np.zeros((capacity, scans.shape[1]), np.float32)
    mb = np.zeros(capacity, np.float32)
    n = len(poses)
    pb[:n], sb[:n], mb[:n] = poses, scans, 1.0
    return pb, sb, mb


def _assert_rebuild_close_to_jax(cfg, coords, pools, jax_pools):
    """A from-scratch rebuild against the JAX package's (module
    docstring's tolerances)."""
    g, s = (_stitched(p.tiles, coords) for p in pools)
    jg, js = (_stitched(np.asarray(p.tiles), coords) for p in jax_pools)
    g_off = g != jg
    print(f"rebuild log-odds: {g_off.sum()} cells differ")
    assert g_off.mean() <= MAP_CELL_SHARE
    halo = blur_halo_cells(to_port(cfg).matcher, TTCFG.resolution)
    near = binary_dilation(g_off, structure=np.ones((3, 3), bool),
                           iterations=halo + 1)
    far = np.abs(s - js)[~near]
    print(f"rebuild search space: max |diff| {far.max():.3g} away from "
          f"them, {(np.abs(s - js) > 1e-5).mean():.3g} of cells off")
    assert far.max() <= 1e-6
    assert (np.abs(s - js) > 1e-5).mean() <= S_CELL_SHARE


@pytest.mark.parametrize("eps_cells", [0.25, 0.0])
def test_incremental_tiled_rebuild_bitexact_after_tracking_writes(eps_cells):
    """tests/test_incremental_rebuild.py's tiled correction rounds in the
    port, at the incremental rebuild's snap (0.25 cells) and at
    incremental_rebuild=False's (0: only keyframes whose float32 pose did
    not move keep their integrations): the incremental rebuild equals a
    from-scratch rebuild at the snapped poses bit for bit, also after the
    returned pools were written into in place (as the tracking writes
    them) before the next round. Each round it replays the keyframes
    that the JAX package's IncrementalTiledRebuilder at the same
    eps_cells replays (the same snapped poses, cached prefix and count of
    integrated scans; JAX's chunk rebuild is left out of that one, as the
    choice does not read the pools). The last two rounds move only a
    suffix, leaving a prefix's bits as they were, so that eps 0 caches
    and replays from the cache too. Every round has padded slots (20
    keyframes in chunks of 8): their search-space windows are written,
    one build a round; the first round's from-scratch rebuild is held to
    the JAX package's."""
    cfg = _rebuild_cfg()
    port = to_port(cfg)
    capacity, chunk = 32, 8
    poses, scans = _keyframes(cfg)
    inc = tfst.IncrementalTiledRebuilder(port, TTCFG, capacity, chunk=chunk,
                                         eps_cells=eps_cells, device=CPU)
    full = tfst.make_tiled_rebuild_fn(port, TTCFG, capacity, chunk=chunk,
                                      device=CPU)
    jinc = jfst.IncrementalTiledRebuilder(cfg, JTCFG, capacity, chunk=chunk,
                                          eps_cells=eps_cells)
    jax_integrated = []

    def jax_chunk(grid, sgrid, poses_, scans_, mask_):
        jax_integrated[-1] += int(np.asarray(mask_).sum())
        return grid, sgrid

    jinc._rebuild_chunk = jax_chunk
    rng = np.random.default_rng(1)
    table = ttiles.TileTable(TTCFG)
    grid = ttiles.tiled_init(TTCFG, CPU)
    reach = cfg.sensor.max_range + 2.0
    cur = poses
    # (k0, every pose moved by a float epsilon as well)
    rounds = [(0, True), (12, True), (len(poses), True), (18, True),
              (17, False), (18, False)]
    for round_i, (k0, eps_noise) in enumerate(rounds):
        if round_i:
            cur = cur.copy()
            if eps_noise:
                cur[:, :2] += rng.normal(0, 1e-5, (len(cur), 2)).astype(
                    np.float32)
            cur[k0:, :2] += rng.normal(0, 0.05, (len(cur) - k0, 2)).astype(
                np.float32)
            cur[k0:, 2] += rng.normal(0, 0.05, len(cur) - k0).astype(
                np.float32)
        grid = table.activate(grid, ttiles.required_tiles(cur[:, :2], reach,
                                                           TTCFG))
        pb, sb, mb = _pad(capacity, cur, scans)
        tfst.run_full_slam_tiled.rebuilt_fields = 0
        tfst.run_full_slam_tiled.rebuilt_scans = 0
        g_inc, s_inc = inc(table, pb, sb, mb, n_active=len(cur))
        jax_integrated.append(0)
        jinc(jnp.asarray(table.coords), pb, sb, mb, n_active=len(cur))
        assert inc.cache_k == jinc.cache_k, f"round {round_i}"
        assert (tfst.run_full_slam_tiled.rebuilt_scans
                == jax_integrated[-1]), f"round {round_i}"
        np.testing.assert_array_equal(inc.map_poses, jinc.map_poses)
        pb2, _, _ = _pad(capacity, inc.map_poses[: len(cur)], scans)
        g_ref, s_ref = full(table, pb2, sb, mb, n_active=len(cur))
        assert torch.equal(g_inc.tiles, g_ref.tiles), f"round {round_i}"
        assert torch.equal(s_inc.tiles, s_ref.tiles), f"round {round_i}"
        assert torch.equal(g_inc.coords, g_ref.coords)
        if round_i == 0:
            # 20 integrations and one build for the 4 padded slots, twice
            assert tfst.run_full_slam_tiled.rebuilt_fields == 2 * 21
            jtab = jtiles.TileTable(JTCFG)
            jgrid = jtab.activate(jtiles.tiled_init(JTCFG),
                                  jtiles.required_tiles(cur[:, :2], reach,
                                                        JTCFG))
            np.testing.assert_array_equal(np.asarray(jgrid.coords),
                                          table.coords)
            jax_pools = jfst.make_tiled_rebuild_fn(
                cfg, JTCFG, capacity, chunk=chunk)(
                jgrid.coords, pb2, sb, mb, n_active=len(cur))
            _assert_rebuild_close_to_jax(cfg, table.coords, (g_ref, s_ref),
                                         jax_pools)
        if round_i == 3 and eps_cells:
            assert inc.cache_k == 16
        # tracking writes into the returned pools in place
        g_inc.tiles[:, 40:60, 20:90] += 0.5
        s_inc.tiles[0].fill_(3.0)
    # eps 0: a full replay every round until the prefix stays put, then
    # from the cache (16 of the 20 keyframes kept)
    want = [20] * 5 + [4] if not eps_cells else None
    if want is not None:
        assert jax_integrated == want
    assert inc.cache_k > 0


@pytest.mark.parametrize("seed", [0, 1])
def test_host_cell_matches_world_to_cell_global(seed):
    """The rebuild's host cell of a keyframe pose is the device's
    world_to_cell_global of the same float32 values, also on cell edges
    and at negative coordinates."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-30.0, 30.0, (4000, 2)).astype(np.float32)
    xy[:1000] = (rng.integers(-300, 300, (1000, 2)) * 0.1).astype(np.float32)
    tcfg = ttiles.TileConfig(tile=128, resolution=0.05 if seed else 0.1,
                             origin_x=0.3 * seed, origin_y=-0.7 * seed)
    dev = ttiles.world_to_cell_global(torch.as_tensor(xy), tcfg).numpy()
    host = np.array([tfst._global_cell(p, tcfg) for p in xy])
    np.testing.assert_array_equal(host, dev)


def test_split_run_matches_single_run():
    """tests/test_resume.py's tiled split: a run split at a chunk boundary
    and resumed from the first part's checkpoint (as numpy arrays of
    fullslam_tiled_ckpt_template's schema) gives the single run's
    keyframes, loops and part-2 trajectory; the checkpoint is left as it
    was."""
    _, full = _runs("dense")
    log = _log()
    T = len(log["odom"])
    cut = (T // 2 // CFG.chunk) * CFG.chunk
    port, gport = to_port(CFG), to_port(GCFG)
    first = {k: v[:cut] for k, v in log.items()}
    second = {k: v[cut:] for k, v in log.items()}
    res_a = tfst.run_full_slam_tiled(first, port, TTCFG, gport, device=CPU)
    template = tfst.fullslam_tiled_ckpt_template(port, TTCFG, gport)
    assert res_a.ckpt.keys() == template.keys()

    def host(x):
        if isinstance(x, tuple):
            return type(x)(*(host(v) for v in x))
        return x.numpy() if isinstance(x, torch.Tensor) else x

    def leaves(x):
        return [y for v in x for y in leaves(v)] if isinstance(x, tuple) \
            else [x]

    saved = {k: host(v) for k, v in res_a.ckpt.items()}
    for k, v in saved.items():
        a, b = leaves(v), leaves(template[k])
        assert [np.shape(x) for x in a] == [np.shape(x) for x in b], k
    keep = saved["frontend"].grid.tiles.copy()
    res_b = tfst.run_full_slam_tiled(second, port, TTCFG, gport, device=CPU,
                                     resume=saved, scan_index_offset=cut)
    assert res_b.n_loops == full.n_loops
    np.testing.assert_array_equal(res_b.kf_scan_idx, full.kf_scan_idx)
    np.testing.assert_allclose(res_b.kf_poses, full.kf_poses, atol=1e-3)
    np.testing.assert_allclose(res_b.traj, full.traj[cut:], atol=1e-3)
    np.testing.assert_array_equal(saved["frontend"].grid.tiles, keep)
