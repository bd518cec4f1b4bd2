"""PyTorch port: the log loaders and writers (data/carmen.py), the native
parser's binding (data/native.py), the loader's dispatcher
(data/__init__.py) and the relations metric (metrics.py), against the
JAX package's, on the CPU.

Inputs are the files of tests/test_native_parser.py and
tests/test_aux.py:61-104, written here from the same seeds: a plain
FLASER log, the fuzz file (corrupt first row, wrong counts, garbage), the
real-world variance matrix (legacy rows, ROBOTLASER1, CRLF, comma
decimals, a truncated last line), timestamped rows, and the JSON shapes.

Tolerances:
- the port's Python parser against the JAX package's: equal arrays (the
  same code), NaN stamps where JAX has them;
- the native parser against the Python one: the JAX tests' (odom 1e-5
  relative and absolute, ranges 1e-5 relative and 1e-4 absolute; stamps
  1e-9): strtod and Python's float round the same decimal the same way,
  but the C++ parser accumulates some fields itself;
- the writers: byte-equal files; the metrics: equal floats (the same
  numpy code).
"""

import json

import numpy as np
import pytest

from slam2d_tpu import metrics as jmetrics
from slam2d_tpu.data import carmen as jcarmen
from slam2d_tpu_torch import data as tdata
from slam2d_tpu_torch import metrics as tmetrics
from slam2d_tpu_torch.data import carmen as tcarmen
from slam2d_tpu_torch.data import native


# ---- the files of tests/test_native_parser.py and tests/test_aux.py -------

def _plain_log(rows=50, beams=12):
    rng = np.random.default_rng(1)
    lines = ["# carmen log\n", "PARAM robot_frontlaser_offset 0.08\n"]
    for t in range(rows):
        r = rng.uniform(0.5, 20.0, beams)
        pose = rng.uniform(-10, 10, 6)
        lines.append(
            "FLASER %d %s %s 1.0 host 1.0\n"
            % (beams, " ".join(f"{v:.3f}" for v in r),
               " ".join(f"{v:.6f}" for v in pose))
        )
        if t % 7 == 0:
            lines.append("ODOM 1 2 3 0 0 0 ts host lts\n")
    return "".join(lines)


def _fuzz_log():
    rng = np.random.default_rng(42)
    beams = 7
    lines = [
        "FLASER 361 0.5\n",
        "FLASER 0 1 2 3 4 5 6 ts host lts\n",
        "FLASER -3 1 2 3 4 5 6 7 8 9 ts h l\n",
        "FLASER seven 1 2 3 4 5 6 ts host lts\n",
    ]
    for t in range(200):
        r = rng.uniform(0, 90, beams)
        pose = rng.normal(0, 30, 6)
        fmt = rng.choice(["%.3f", "%.6f", "%.1e", "%g"])
        vals = " ".join(fmt % v for v in r)
        ps = " ".join("%.8g" % v for v in pose)
        lines.append(f"FLASER {beams} {vals} {ps} 1.0 host 1.0\n")
        if t % 11 == 0:
            lines.append("TRUEPOS 1 2 3 4 5 6 ts host lts\n")
        if t % 17 == 0:
            lines.append("FLASER 3 1.0 2.0 3.0 0 0 0 0 0 0 ts host lts\n")
        if t % 23 == 0:
            bad = vals.replace(vals.split()[2], "oops", 1)
            lines.append(f"FLASER {beams} {bad} {ps} 1.0 host 1.0\n")
    return "".join(lines)


def _variance_log():
    rng = np.random.default_rng(3)
    beams = 9

    def fmt(v):
        return " ".join("%.3f" % x for x in v)

    def pose6(v):
        return " ".join("%.6f" % x for x in v)

    lines = ["# robot log, exported 1999-06-12\r\n",
             "PARAM laser_front_laser_resolution 0.5\r\n"]
    for t in range(60):
        r = rng.uniform(0.1, 50.0, beams)
        pose = rng.normal(0, 20, 3)
        odom = rng.normal(0, 20, 3)
        kind = t % 3
        if kind == 0:
            lines.append("FLASER %d %s %s %s 12.5 laptop2 12.6\n"
                         % (beams, fmt(r), pose6(pose), pose6(odom)))
        elif kind == 1:
            lines.append("FLASER %d %s %s 9.25 dorothy 9.30\n"
                         % (beams, fmt(r), pose6(pose)))
        else:
            n_rem = t % 5
            rem = " ".join("0" for _ in range(n_rem))
            lines.append(
                "ROBOTLASER1 0 -1.5708 3.14159 0.0175 81.9 0.01 0 %d %s %d "
                "%s %s %s 0.3 0.05 0.5 0.2 0.3 77.1 host 77.2\n"
                % (beams, fmt(r), n_rem, rem, pose6(pose), pose6(odom))
            )
        if t % 10 == 0:
            lines.append("ODOM 1 2 3 0 0 0 55.5 host 55.6\r\n")
    r = rng.uniform(0.1, 50.0, beams)
    lines.append(
        "FLASER %d %s 1,5 -2,25 0,75 1,5 -2,25 0,75 3.0 host 3.1\n"
        % (beams, " ".join(("%.3f" % v).replace(".", ",") for v in r))
    )
    lines.append("FLASER %d 1.0 2.0 3.0" % beams)
    return "".join(lines)


def _stamps_log():
    rng = np.random.default_rng(11)
    beams = 5
    lines = []
    for t in range(40):
        r = rng.uniform(1.0, 10.0, beams)
        pose = np.array([0.3 * t, 0.1 * t, 0.01 * t])
        rs = " ".join("%.3f" % v for v in r)
        ps = " ".join("%.6f" % v for v in pose)
        ts = 100.0 + 0.25 * t
        if t % 3 == 2:
            lines.append(f"FLASER {beams} {rs} {ps} {ts:.6f} bot {ts:.6f}\n")
        else:
            lines.append(
                f"FLASER {beams} {rs} {ps} {ps} {ts:.6f} bot {ts:.6f}\n")
    return "".join(lines)


def _aux_log():
    line = "FLASER 4 1.0 2.0 3.0 4.0 0.5 0.6 0.1 0.55 0.65 0.12 ts host lts\n"
    return "# comment\nODOM 0 0 0 0 0 0 ts host lts\n" + line


FILES = {
    "plain": _plain_log, "fuzz": _fuzz_log, "variance": _variance_log,
    "stamps": _stamps_log, "aux": _aux_log,
}


def _write(tmp_path, name):
    p = tmp_path / f"{name}.clf"
    p.write_text(FILES[name]())
    return str(p)


def _assert_same(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("name", sorted(FILES))
def test_python_parser_equals_jax(tmp_path, name):
    path = _write(tmp_path, name)
    _assert_same(tcarmen.load_carmen_log(path), jcarmen.load_carmen_log(path))


@pytest.mark.parametrize("name", sorted(FILES))
def test_native_parser_equals_python(tmp_path, name):
    if not native.native_available():
        pytest.skip("no C++ compiler to build the native parser")
    path = _write(tmp_path, name)
    py = jcarmen.load_carmen_log(path)
    nat = native.load_carmen_log_native(path)
    assert nat["odom"].shape == py["odom"].shape
    assert nat["ranges"].shape == py["ranges"].shape
    np.testing.assert_allclose(nat["odom"], py["odom"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(nat["ranges"], py["ranges"], rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(nat["stamps"], py["stamps"], atol=1e-9)


def test_native_library_is_built_into_the_build_dir():
    if not native.native_available():
        pytest.skip("no C++ compiler to build the native parser")
    path = native.library_path()
    assert path.exists() and path.parent == native.BUILD_DIR
    assert path.name.startswith("libcarmen_parser_")


def test_dispatcher_reports_the_parser(tmp_path, monkeypatch):
    path = _write(tmp_path, "plain")
    log = tdata.load_carmen_log(path)
    assert log["ranges"].shape == (50, 12)
    want = "native" if native.native_available() else "python"
    assert tdata.load_carmen_log.last_parser == want
    monkeypatch.setattr(native, "native_available", lambda: False)
    _assert_same(tdata.load_carmen_log(path), jcarmen.load_carmen_log(path))
    assert tdata.load_carmen_log.last_parser == "python"


def test_unparseable_log_raises_in_both_parsers(tmp_path):
    p = tmp_path / "bad.clf"
    p.write_text("FLASER 5 a b c d e 1 2 3 4 5 6 ts h l\n")
    with pytest.raises(ValueError):
        tcarmen.load_carmen_log(str(p))
    if native.native_available():
        with pytest.raises(ValueError):
            native.load_carmen_log_native(str(p))


def test_json_loader_equals_jax(tmp_path):
    records = [
        {"x": 0.0, "y": 0.0, "theta": 0.0, "range": [1.0, 2.0]},
        {"x": 0.1, "y": 0.0, "t": 0.2, "ranges": [1.1, 2.1], "ts": 4.5},
    ]
    f = tmp_path / "log.json"
    f.write_text(json.dumps(records))
    _assert_same(tcarmen.load_json_log(str(f)), jcarmen.load_json_log(str(f)))
    f2 = tmp_path / "log2.json"
    f2.write_text(json.dumps({"map": {"11.5": records[0], "10.5": records[1]}}))
    _assert_same(tcarmen.load_json_log(str(f2)),
                 jcarmen.load_json_log(str(f2)))


def test_writers_are_byte_equal_to_jax(tmp_path):
    rng = np.random.default_rng(3)
    log = {
        "odom": rng.normal(size=(12, 3)).astype(np.float32),
        "ranges": rng.uniform(0.3, 11.0, (12, 30)).astype(np.float32),
    }
    for fn in ("save_carmen_log", "save_json_log"):
        a, b = tmp_path / f"port_{fn}", tmp_path / f"jax_{fn}"
        getattr(tcarmen, fn)(str(a), log)
        getattr(jcarmen, fn)(str(b), log)
        assert a.read_bytes() == b.read_bytes(), fn
    a, b = tmp_path / "port.json", tmp_path / "jax.json"
    tcarmen.carmen_to_json(str(tmp_path / "port_save_carmen_log"), str(a))
    jcarmen.carmen_to_json(str(tmp_path / "port_save_carmen_log"), str(b))
    assert a.read_bytes() == b.read_bytes()
    assert tcarmen.main([str(tmp_path / "port_save_carmen_log"),
                         str(tmp_path / "main.json")]) == 0
    assert (tmp_path / "main.json").read_bytes() == b.read_bytes()


def _relations(tmp_path, poses, stamps, pairs):
    # a comment, a short row, a non-numeric row, a relation no pose is
    # near in time (not used)
    lines = ["# comment line\n", "1 2 3\n", "a b c d e f g h\n",
             "900.0 901.0 1 0 0 0 0 0\n"]
    for a, b in pairs:
        pa, pb = poses[a], poses[b]
        c, s = np.cos(pa[2]), np.sin(pa[2])
        d = pb[:2] - pa[:2]
        lines.append(
            f"{stamps[a]:.6f} {stamps[b]:.6f} {c * d[0] + s * d[1]:.9f} "
            f"{-s * d[0] + c * d[1]:.9f} 0 0 0 {pb[2] - pa[2]:.9f}\n")
    p = tmp_path / "relations.txt"
    p.write_text("".join(lines))
    return str(p)


def test_relations_metric_equals_jax(tmp_path):
    rng = np.random.default_rng(5)
    poses = np.cumsum(rng.normal(0, [0.2, 0.2, 0.05], (60, 3)), axis=0)
    stamps = 100.0 + 0.25 * np.arange(60)
    stamps[[7, 8]] = np.nan
    pairs = [(0, 30), (5, 25), (10, 59), (9, 20), (40, 41)]
    path = _relations(tmp_path, poses, stamps, pairs)
    rel_t, rel_j = tmetrics.load_relations(path), jmetrics.load_relations(path)
    np.testing.assert_array_equal(rel_t, rel_j)
    est = poses + rng.normal(0, 0.05, poses.shape)
    out_t = tmetrics.rpe_relations(est, stamps, rel_t)
    assert out_t == jmetrics.rpe_relations(est, stamps, rel_j)
    assert out_t["n_used"] == 5 and out_t["n_total"] == 6
    exact = tmetrics.rpe_relations(poses, stamps, rel_t)
    assert exact["trans_rmse"] < 1e-5 and exact["rot_rmse"] < 1e-6
    for delta in (1, 3):
        assert tmetrics.rpe_rmse(est, poses, delta) == jmetrics.rpe_rmse(
            est, poses, delta)
    empty = tmp_path / "empty.txt"
    empty.write_text("# nothing\n")
    with pytest.raises(ValueError):
        tmetrics.load_relations(str(empty))
