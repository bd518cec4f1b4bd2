"""PyTorch port: search space, scorer and matcher against
slam2d_tpu.match.correlative (CPU).

The JAX functions run jitted, as the JAX frontend runs them: XLA turns
each division by a config constant into a multiplication by its
reciprocal, and the port follows that rounding.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam2d_tpu.config import GridConfig, MatcherConfig
from slam2d_tpu.grid import occupancy as jocc
from slam2d_tpu.match import correlative as jcor
from slam2d_tpu_torch.grid import occupancy as tocc
from slam2d_tpu_torch.match import correlative as tcor
from slam2d_tpu_torch.ops import score as tscore
from slam2d_tpu_torch.ops import search_space as tfield
from torch_parity import SENSOR, synth_ranges, to_port

import chip_smoke

torch.set_num_threads(1)

GCFG = GridConfig(
    height=200, width=200, resolution=0.1, center_x=10.0, center_y=10.0
)
MCFG = MatcherConfig(
    search_xy=0.3, search_theta=0.15, n_theta=13, score_impl="gather"
)
POSE = np.array([6.3, 5.8, 0.4], np.float32)


@functools.cache
def _jax_map() -> np.ndarray:
    """A log-odds map built by the JAX package from five scans."""
    g = jocc.make_grid(GCFG)
    for k in range(5):
        p = POSE + np.float32(k) * np.array([0.2, 0.1, 0.02], np.float32)
        g = jocc.integrate_scan(
            g, jnp.asarray(p), jnp.asarray(synth_ranges(p)), GCFG, SENSOR
        )
    return np.array(g)  # writable, for torch.from_numpy


def test_gaussian_taps_and_theta_offsets_match_jax():
    for sigma, hw in ((1.0, 4), (2.0, 6), (0.3, 4)):
        np.testing.assert_array_equal(
            tcor.gaussian_kernel_1d(sigma, hw),
            jcor._gaussian_kernel_1d(sigma, hw),
        )
    for m in (MCFG, dataclasses.replace(MCFG, n_theta=1)):
        np.testing.assert_array_equal(
            tcor._theta_offsets(to_port(m)), jcor._theta_offsets(m)
        )


@pytest.mark.parametrize("resolution", [0.1, 0.05])
def test_build_search_space_matches_jax(resolution):
    lo = np.random.default_rng(4).uniform(-4, 4, (90, 70)).astype(np.float32)
    lo[20:30, 10:60] = 3.0
    fn = jax.jit(jcor.build_search_space, static_argnums=(1, 2))
    ref = np.asarray(fn(jnp.asarray(lo), MCFG, resolution))
    out = tcor.build_search_space(
        torch.from_numpy(lo), to_port(MCFG), resolution
    ).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize(
    "shape,factor", [((64, 48), 4), ((66, 49), 4), ((30, 30), 3)]
)
def test_coarse_space_matches_jax(shape, factor):
    S = np.random.default_rng(6).normal(size=shape).astype(np.float32)
    ref = np.asarray(jcor.coarse_space(jnp.asarray(S), factor))
    out = tcor.coarse_space(torch.from_numpy(S), factor).numpy()
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("bilinear", [True, False])
@pytest.mark.parametrize("case", ["inside", "edge", "nan"])
def test_score_offsets_matches_gather(bilinear, case):
    rng = np.random.default_rng(7)
    S = rng.uniform(-0.6, 1.0, (60, 72)).astype(np.float32)
    ranges = synth_ranges(POSE)
    if case == "nan":
        ranges[::5] = np.nan
    # window origin: "edge" puts the scan across the window's borders
    origin = (5.0, 4.5) if case != "edge" else (6.9, 6.1)
    cell = 0.1 if bilinear else 0.4
    radius = 4 if bilinear else 2
    dth = np.linspace(-0.1, 0.1, 5).astype(np.float32)
    prior = POSE + np.array([0.03, -0.02, 0.01], np.float32)
    offs = jnp.arange(-radius, radius + 1, dtype=jnp.int32)

    @jax.jit
    def ref_fn(S, prior, ranges, dth):
        pts, valid = jocc.scan_endpoints_local(ranges, SENSOR)
        return jcor.score_offsets(
            S, prior, pts, valid, dth, offs, offs, cell,
            jnp.asarray(origin, jnp.float32), bilinear=bilinear, impl="gather",
        )

    ref = np.asarray(ref_fn(*map(jnp.asarray, (S, prior, ranges, dth))))
    pts, valid = tocc.scan_endpoints_local(
        torch.from_numpy(ranges), to_port(SENSOR)
    )
    out = tcor.score_offsets(
        torch.from_numpy(S), torch.from_numpy(prior), pts, valid,
        torch.from_numpy(dth), radius, cell, origin, bilinear=bilinear,
    ).numpy()
    assert out.shape == ref.shape == (5, 2 * radius + 1, 2 * radius + 1)
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


# bench.py's matcher (1024^2 grid at 0.05 m, coarse_factor 4, search_xy
# 0.3 m, n_theta 13): (window cells, cell size, radius, thetas, bilinear)
FRONTEND_PASSES = {
    "coarse": (136, 0.2, 2, 13, False),   # [13, 5, 5] on the pooled window
    "fine": (544, 0.05, 4, 5, True),      # [5, 9, 9] on the scan window
}


def _frontend_pass_operands(pass_name):
    """S, ranges (every 9th invalid), the window's origin, the pass's
    theta offsets and the prior of one frontend pass."""
    size, cell, radius, T, bilinear = FRONTEND_PASSES[pass_name]
    rng = np.random.default_rng(size)
    S = rng.uniform(-0.6, 1.0, (size, size)).astype(np.float32)
    ranges = synth_ranges(POSE)
    ranges[::9] = np.nan
    # the window centered on the pose, as the frontend's scan window is
    origin = (float(POSE[0]) - 13.55, float(POSE[1]) - 13.65)
    dth = np.linspace(-0.15, 0.15, 13).astype(np.float32)[
        (13 - T) // 2:(13 + T) // 2]
    prior = POSE + np.array([0.03, -0.02, 0.01], np.float32)
    return S, ranges, origin, dth, prior


def _port_positions(prior, ranges, dth, cell, origin):
    pts, valid = tocc.scan_endpoints_local(
        torch.from_numpy(ranges), to_port(SENSOR)
    )
    pos = tcor.endpoint_positions(
        torch.from_numpy(prior), pts, valid, torch.from_numpy(dth), cell,
        origin,
    )
    return pos, valid


@pytest.mark.parametrize("pass_name", sorted(FRONTEND_PASSES))
def test_score_window_plain_matches_gather_at_frontend_shapes(pass_name):
    """The scorer's plain version (which the kernel is held against on the
    GPU) at the frontend's own shapes, 180 beams (every 9th invalid),
    against the JAX package's score_offsets(impl="gather")."""
    size, cell, radius, T, bilinear = FRONTEND_PASSES[pass_name]
    S, ranges, origin, dth, prior = _frontend_pass_operands(pass_name)
    offs = jnp.arange(-radius, radius + 1, dtype=jnp.int32)

    @jax.jit
    def ref_fn(S, prior, ranges, dth):
        pts, valid = jocc.scan_endpoints_local(ranges, SENSOR)
        return jcor.score_offsets(
            S, prior, pts, valid, dth, offs, offs, cell,
            jnp.asarray(origin, jnp.float32), bilinear=bilinear, impl="gather",
        )

    ref = np.asarray(ref_fn(*map(jnp.asarray, (S, prior, ranges, dth))))
    (pos_row, pos_col), valid = _port_positions(prior, ranges, dth, cell,
                                                origin)
    assert tuple(pos_row.shape) == (T, 180)
    out = tscore.score_window_plain(
        torch.from_numpy(S), pos_row, pos_col, valid, radius, bilinear
    ).numpy()
    n = 2 * radius + 1
    assert out.shape == ref.shape == (T, n, n)
    assert np.isfinite(out).all() and np.abs(out).max() > 0.05
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("shift", [0.0, 0.45])
@pytest.mark.parametrize("pass_name", sorted(FRONTEND_PASSES))
def test_score_bound_counts_the_cells_under_the_taps(pass_name, shift):
    """chip_smoke.py's bound of the scorer reads each cell of S under a
    valid beam's taps once: the distinct in-bounds cells of the (n + 1)^2
    patches from floor(pos) (bilinear) or the n^2 patches around
    round(pos), counted here beam by beam, with the endpoints moved by
    `shift` windows so that some patches leave S."""
    size, cell, radius, T, bilinear = FRONTEND_PASSES[pass_name]
    S, ranges, origin, dth, prior = _frontend_pass_operands(pass_name)
    pos, valid = _port_positions(prior, ranges, dth, cell, origin)
    pos = tuple(p - shift * size for p in pos)
    n = 2 * radius + 1
    cells = set()
    rnd = np.floor if bilinear else np.round
    lo, hi = -radius, radius + (2 if bilinear else 1)
    for t in range(T):
        for b in np.flatnonzero(valid.numpy()):
            r0 = int(rnd(pos[0][t, b].item()))
            c0 = int(rnd(pos[1][t, b].item()))
            cells.update(
                (r, c) for r in range(r0 + lo, r0 + hi)
                for c in range(c0 + lo, c0 + hi)
                if 0 <= r < size and 0 <= c < size
            )
    B, nv = valid.numel(), int(valid.sum())
    bound = chip_smoke.score_bound(torch.from_numpy(S), pos, valid, n,
                                   bilinear)
    assert 0 < len(cells) < size * size
    assert bound["bytes"] == 4 * len(cells) + 8 * T * B + B + 4 * T * n * n
    assert bound["operations"] == T * n * n * nv * 2 * (4 if bilinear else 1)


@pytest.mark.parametrize("windowed", [False, True])
def test_match_scan_matches_jax(windowed):
    lo = _jax_map()
    true_pose = POSE + np.array([0.4, 0.2, 0.04], np.float32)
    prior = true_pose + np.array([0.12, -0.08, 0.05], np.float32)
    ranges = synth_ranges(true_pose)
    if windowed:
        S = np.asarray(
            jcor.build_search_space(jnp.asarray(lo), MCFG, GCFG.resolution)
        )
        r0, c0 = 40, 52
        Sw = np.ascontiguousarray(S[r0 : r0 + 128, c0 : c0 + 128])
        origin = tocc.window_origin_xy(to_port(GCFG), (r0, c0))
        kw_j = dict(search_space=jnp.asarray(Sw), origin_xy=origin)
        kw_t = dict(search_space=torch.from_numpy(Sw), origin_xy=origin)
    else:
        kw_j, kw_t = {}, {}

    fn = jax.jit(
        lambda lo, r, p, **kw: jcor.match_scan(lo, r, p, GCFG, MCFG, SENSOR, **kw)
    )
    jp, js = fn(jnp.asarray(lo), jnp.asarray(ranges), jnp.asarray(prior), **kw_j)
    tp, ts = tcor.match_scan(
        torch.from_numpy(lo), torch.from_numpy(ranges), torch.from_numpy(prior),
        to_port(GCFG), to_port(MCFG), to_port(SENSOR), **kw_t,
    )
    jp, tp = np.asarray(jp), tp.numpy()
    print("pose diff", np.abs(jp - tp), "score diff", abs(float(js) - float(ts)))
    np.testing.assert_allclose(tp, jp, rtol=0, atol=1e-4)
    assert abs(float(ts) - float(js)) <= 1e-5
    assert float(ts) > MCFG.min_score  # a real lock, not the prior fallback
    assert np.hypot(*(tp[:2] - true_pose[:2])) < 0.15


@pytest.mark.parametrize(
    "bad", ["S_dtype", "pos_shape", "valid_dtype", "radius", "device"]
)
def test_score_wrapper_rejects_bad_input(bad):
    S, pr, pc = torch.zeros(40, 40), torch.zeros(5, 180), torch.zeros(5, 180)
    valid, radius = torch.ones(180, dtype=torch.bool), 4
    if bad == "S_dtype":
        S = S.double()
    elif bad == "pos_shape":
        pc = torch.zeros(5, 179)
    elif bad == "valid_dtype":
        valid = valid.float()
    elif bad == "radius":
        radius = 16
    else:
        S, pr, pc, valid = (t.to("meta") for t in (S, pr, pc, valid))
    with pytest.raises(ValueError):
        tscore.score_window(S, pr, pc, valid, radius, True)


@pytest.mark.parametrize("bad", ["even_taps", "dtype", "device"])
def test_search_space_wrapper_rejects_bad_input(bad):
    lo, taps = torch.zeros(40, 40), tcor.gaussian_kernel_1d(2.0, 6)
    if bad == "even_taps":
        taps = taps[:-1]
    elif bad == "dtype":
        lo = lo.double()
    else:
        lo = lo.to("meta")
    with pytest.raises(ValueError):
        tfield.search_space(
            lo, taps, occ_sat=2.0, free_threshold=0.45, free_penalty=0.6
        )


# peak_uniqueness scores loop-closure matches over a wide window: 1.2 m is
# 7 x 7 coarse offsets of 0.4 m, some beyond either exclusion radius (at
# MCFG's 0.3 m every offset lies within it and the margin is +inf)
PEAK_MCFG = dataclasses.replace(MCFG, search_xy=1.2)
# poses of the scans peak_uniqueness is held at: the map's own pose, one
# across the room from it, and one in the window the windowed case cuts
PEAK_SCANS = {
    "near": (np.array([0.4, 0.2, 0.04], np.float32), False),
    "far": (np.array([1.1, -0.6, -0.08], np.float32), False),
    "window": (np.array([0.4, 0.2, 0.04], np.float32), True),
}


@pytest.mark.parametrize("excl_m", [0.3, 0.5])
@pytest.mark.parametrize("scan", sorted(PEAK_SCANS))
def test_peak_uniqueness_matches_jax(scan, excl_m):
    lo = _jax_map()
    offset, windowed = PEAK_SCANS[scan]
    true_pose = POSE + offset
    prior = true_pose + np.array([0.06, -0.05, 0.02], np.float32)
    ranges = synth_ranges(true_pose)
    kw_j, kw_t = {}, {}
    if windowed:
        S = np.asarray(
            jcor.build_search_space(jnp.asarray(lo), MCFG, GCFG.resolution)
        )
        r0, c0 = 40, 52
        Sw = np.ascontiguousarray(S[r0 : r0 + 128, c0 : c0 + 128])
        origin = tocc.window_origin_xy(to_port(GCFG), (r0, c0))
        kw_j = dict(search_space=jnp.asarray(Sw), origin_xy=origin)
        kw_t = dict(search_space=torch.from_numpy(Sw), origin_xy=origin)
    fn = jax.jit(lambda lo, r, p, **kw: jcor.peak_uniqueness(
        lo, r, p, GCFG, PEAK_MCFG, SENSOR, excl_m=excl_m, **kw))
    ref = float(fn(jnp.asarray(lo), jnp.asarray(ranges), jnp.asarray(prior),
                   **kw_j))
    out = tcor.peak_uniqueness(
        torch.from_numpy(lo), torch.from_numpy(ranges), torch.from_numpy(prior),
        to_port(GCFG), to_port(PEAK_MCFG), to_port(SENSOR), excl_m=excl_m,
        **kw_t,
    )
    print(f"margin port {float(out):.7g} JAX {ref:.7g}")
    assert out.dim() == 0 and np.isfinite(ref) and ref > 0
    assert abs(float(out) - ref) <= 2e-6


@pytest.mark.parametrize(
    "name", sorted(chip_smoke.search_space_edge_operands())
)
def test_search_space_plain_matches_jax_at_edge_operands(name, monkeypatch):
    """build_search_space's plain version (which kernel 3 is held to on
    the GPU) against the JAX package's on chip_smoke.py's edge operands:
    shapes that are no multiple of a tile, 3 to 63 taps (the halo set on
    both packages' blur_halo_cells, sigma halo / 3 cells at a cell of
    1 m), log-odds at the clips and around logit(free_threshold)."""
    op = chip_smoke.search_space_edge_operands()[name]
    hw = op["halo"]
    mcfg = dataclasses.replace(MCFG, sigma_m=hw / 3)
    monkeypatch.setattr("slam2d_tpu.grid.window.blur_halo_cells",
                        lambda m, r: hw)
    monkeypatch.setattr(tcor, "blur_halo_cells", lambda m, r: hw)
    lo = op["logodds"]
    ref = np.asarray(jax.jit(
        lambda x: jcor.build_search_space(x, mcfg, 1.0))(jnp.asarray(lo)))
    out = tcor.build_search_space(
        torch.from_numpy(lo), to_port(mcfg), 1.0
    ).numpy()
    np.testing.assert_array_equal(
        tcor.gaussian_kernel_1d(hw / 3, hw), op["taps"]
    )
    assert out.shape == lo.shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)
