"""PyTorch port: its own copies of the JAX package's JAX-free modules
(slam2d_tpu_torch/config.py, data/synth.py with default_log, metrics.py,
the numpy SE(2) helpers of run/frontend_tiled.py) against the originals,
and a scan of its sources, the CLI and its loaders, checkpoints,
profiling and exports included, for imports of the JAX package.
Everything here is exact."""

import ast
import dataclasses
import pathlib

import numpy as np
import pytest

import slam2d_tpu.config as jcfg
import slam2d_tpu_torch.config as tcfg
from slam2d_tpu.data import synth as jsynth
from slam2d_tpu.metrics import ate_rmse as jax_ate
from slam2d_tpu_torch.data import synth as tsynth
from slam2d_tpu_torch.metrics import ate_rmse
from torch_parity import frontend_cfg, to_port

ROOT = pathlib.Path(__file__).resolve().parent.parent
CONFIGS = ["SensorConfig", "GridConfig", "MatcherConfig", "PFConfig",
           "GraphConfig", "FrontendConfig"]


@pytest.mark.parametrize("name", CONFIGS)
def test_config_copies_have_the_same_fields_and_defaults(name):
    j, t = getattr(jcfg, name), getattr(tcfg, name)
    jf, tf = dataclasses.fields(j), dataclasses.fields(t)
    assert [f.name for f in tf] == [f.name for f in jf]
    assert [f.type for f in tf] == [f.type for f in jf]
    assert t() == to_port(j())                   # every default
    assert t.__dataclass_params__.frozen
    for attr in ("origin_x", "origin_y", "beam_angles", "n_xy"):
        assert hasattr(j, attr) == hasattr(t, attr)


def test_config_methods_and_properties_agree():
    cfg = frontend_cfg(512)
    port = to_port(cfg)
    assert port.grid.origin_x == cfg.grid.origin_x
    assert port.grid.origin_y == cfg.grid.origin_y
    assert port.matcher.n_xy(0.05) == cfg.matcher.n_xy(0.05)
    a, b = port.sensor.beam_angles(), cfg.sensor.beam_angles()
    assert a.dtype == b.dtype == np.float64
    np.testing.assert_array_equal(a, b)
    assert hash(port) == hash(to_port(cfg))      # usable as a cache key


@pytest.mark.parametrize("seed", [0, 7])
def test_simulate_log_matches_jax(seed):
    wp = np.array([[3.0, 3.0], [3.0, 8.0], [8.0, 8.0], [12.0, 3.5]])
    sensor = jcfg.SensorConfig(n_beams=90, max_range=10.0)
    ref = jsynth.simulate_log(jsynth.SynthWorld.box_rooms(20.0), wp, sensor,
                              step=0.2, seed=seed)
    out = tsynth.simulate_log(tsynth.SynthWorld.box_rooms(20.0), wp,
                              to_port(sensor), step=0.2, seed=seed)
    assert out.keys() == ref.keys()
    for k in ref:
        assert out[k].dtype == ref[k].dtype == np.float32
        np.testing.assert_array_equal(out[k], ref[k])
    np.testing.assert_array_equal(
        tsynth.SynthWorld.box_rooms(16.0).segments,
        jsynth.SynthWorld.box_rooms(16.0).segments,
    )


@pytest.mark.parametrize("span, step, seed", [(60.0, 0.2, 0), (28.0, 0.5, 3)])
def test_corridor_world_and_loop_log_match_jax(span, step, seed):
    np.testing.assert_array_equal(tsynth.corridor_world(span).segments,
                                  jsynth.corridor_world(span).segments)
    sensor = jcfg.SensorConfig(n_beams=90, max_range=10.0)
    jw, ref = jsynth.corridor_loop_log(sensor, span=span, step=step,
                                       seed=seed, odom_noise_xy=0.01)
    tw, out = tsynth.corridor_loop_log(to_port(sensor), span=span, step=step,
                                       seed=seed, odom_noise_xy=0.01)
    np.testing.assert_array_equal(tw.segments, jw.segments)
    assert out.keys() == ref.keys()
    for k in ref:
        assert out[k].dtype == ref[k].dtype == np.float32
        np.testing.assert_array_equal(out[k], ref[k])


@pytest.mark.parametrize("laps, step, seed", [(1, 0.3, 0), (2, 0.5, 4)])
def test_endurance_log_matches_jax(laps, step, seed):
    """endurance_log's lane offsets (drawn with seed + 1000) and log, at a
    coarse step so that the test stays fast."""
    sensor = jcfg.SensorConfig(n_beams=90, max_range=10.0)
    jw, ref = jsynth.endurance_log(sensor, laps=laps, step=step, seed=seed,
                                   odom_noise_xy=0.01)
    tw, out = tsynth.endurance_log(to_port(sensor), laps=laps, step=step,
                                   seed=seed, odom_noise_xy=0.01)
    np.testing.assert_array_equal(tw.segments, jw.segments)
    assert out.keys() == ref.keys()
    for k in ref:
        assert out[k].dtype == ref[k].dtype == np.float32
        np.testing.assert_array_equal(out[k], ref[k])


def test_splice_odom_and_se2_helpers_match_jax():
    from slam2d_tpu.run import frontend_tiled as jft
    from slam2d_tpu_torch.run import frontend_tiled as tft

    sensor = jcfg.SensorConfig(n_beams=30, max_range=10.0)
    world = jsynth.SynthWorld.box_rooms(20.0)
    a = jsynth.simulate_log(world, np.array([[3.0, 3.0], [3.0, 8.0]]),
                            sensor, step=0.3, seed=3)
    b = jsynth.simulate_log(world, np.array([[16.0, 3.5], [12.5, 13.5]]),
                            sensor, step=0.3, seed=4)
    ref = jsynth.splice_odom(a["odom"], b["odom"])
    out = tsynth.splice_odom(a["odom"], b["odom"])
    assert out.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(out, ref)
    p, q = a["odom"][3], b["odom"][5]
    for name in ("_np_between", "_np_compose"):
        np.testing.assert_array_equal(getattr(tft, name)(p, q),
                                      getattr(jft, name)(p, q))
    for name in ("_np_between_batch", "_np_compose_batch"):
        np.testing.assert_array_equal(getattr(tft, name)(p, b["odom"]),
                                      getattr(jft, name)(p, b["odom"]))
    np.testing.assert_array_equal(tft._np_inverse(q), jft._np_inverse(q))


def test_ate_matches_jax():
    rng = np.random.default_rng(3)
    gt = rng.uniform(0, 10, (50, 3)).astype(np.float32)
    est = gt + rng.normal(0, 0.1, gt.shape).astype(np.float32)
    c, s = np.cos(0.3), np.sin(0.3)
    est[:, :2] = est[:, :2] @ np.array([[c, s], [-s, c]]) + 1.5
    for align in (True, False):
        assert ate_rmse(est, gt, align=align) == jax_ate(est, gt, align=align)


@pytest.mark.parametrize("seed", [0, 3])
def test_default_log_matches_jax(seed):
    """data/synth.default_log, the CLI's `--log synth`: the same world and
    the same arrays, field for field."""
    sensor = jcfg.SensorConfig(n_beams=90)
    jw, ref = jsynth.default_log(sensor, step=0.2, seed=seed)
    tw, out = tsynth.default_log(to_port(sensor), step=0.2, seed=seed)
    np.testing.assert_array_equal(tw.segments, jw.segments)
    assert sorted(out) == sorted(ref)
    for k in ref:
        assert out[k].dtype == np.asarray(ref[k]).dtype, k
        np.testing.assert_array_equal(out[k], np.asarray(ref[k]))


PORT_MODULES = (
    "data/carmen.py", "data/native.py", "data/__init__.py",
    "utils/checkpoint.py", "utils/metrics_logger.py", "utils/profiling.py",
    "viz/render.py", "viz/ros_map.py", "viz/video.py", "run/cli.py",
)


def _port_sources():
    files = sorted((ROOT / "slam2d_tpu_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py", ROOT / "bench_torch.py",
                    ROOT / "bench_pf_torch.py",
                    ROOT / "bench_scaling_torch.py",
                    ROOT / "scripts" / "profile_torch.py",
                    ROOT / "scripts" / "bench_endurance_torch.py",
                    ROOT / "scripts" / "device_parity_torch.py",
                    ROOT / "scripts" / "bench_tiled_rebuild_torch.py",
                    ROOT / "scripts" / "bench_ate_torch.py",
                    ROOT / "scripts" / "bench_fullslam_torch.py",
                    ROOT / "scripts" / "bench_graph_scale_torch.py",
                    ROOT / "scripts" / "dense_factor_probe_torch.py",
                    ROOT / "scripts" / "sharded_pinned_probe.py"]


def test_port_imports_nothing_of_the_jax_package():
    """No file of slam2d_tpu_torch/, nor chip_smoke.py, bench_torch.py,
    bench_pf_torch.py, bench_scaling_torch.py, scripts/profile_torch.py,
    scripts/bench_endurance_torch.py, scripts/device_parity_torch.py,
    scripts/bench_tiled_rebuild_torch.py, scripts/bench_ate_torch.py,
    scripts/bench_fullslam_torch.py, scripts/bench_graph_scale_torch.py,
    scripts/dense_factor_probe_torch.py or scripts/sharded_pinned_probe.py,
    imports slam2d_tpu or jax."""
    bad = []
    files = _port_sources()
    assert len(files) > 20
    for m in PORT_MODULES:
        assert ROOT / "slam2d_tpu_torch" / m in files, m
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for n in names:
                top = n.split(".")[0]
                if top in ("slam2d_tpu", "jax", "jaxlib"):
                    bad.append(f"{path.relative_to(ROOT)}:{node.lineno} {n}")
    assert not bad, bad
