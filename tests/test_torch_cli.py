"""PyTorch port: the command line (run/cli.py) against the JAX
package's (slam2d_tpu/run/cli.py), both called in-process on the CPU, on
the built-in synthetic log at a small size: a 256^2 grid at 0.1 m, chunk
16, `--scan-range` to cut the log, `--update-impl sparse --score-impl
gather` in both (the update and scorer JAX runs on its CPU).

Held: the same JSON keys; frontend and localization trajectories within
5e-3 m / rad of JAX's (the frontend parity's tolerance); full SLAM with
the same keyframe count and loop count, the trajectory within 5e-3;
FastSLAM, whose random streams differ, to the JAX CLI test's bounds
(tests/test_aux.py: N_eff in [1, P], finite ATE); a split run with
--save-state/--resume-state equal to the single run (frontend 1e-4 and
full SLAM 1e-3 after the cut, tests/test_resume.py's tolerances); the
outputs written (trajectory, map, grid.json, the ROS pair, metrics,
map.png, a GIF); --score-impl cmx and emx, the frontend's match through
the correlation scorer, within the frontend tolerance of JAX's; the TPU
scorer workarounds mxu and mxu_int8, which are not ported, raise.
"""

import json
import os

import numpy as np
import pytest
import torch

from slam2d_tpu.run import cli as jcli
from slam2d_tpu_torch.data import carmen as tcarmen
from slam2d_tpu_torch.data.synth import default_log
from slam2d_tpu_torch.config import SensorConfig
from slam2d_tpu_torch.run import cli as tcli
from torch_parity import pose_error

torch.set_num_threads(1)

SMALL = ["--log", "synth", "--grid-size", "256", "--resolution", "0.1",
         "--chunk", "16", "--update-impl", "sparse", "--score-impl",
         "gather", "--gt-ate"]
TOL = 5e-3
CORR_SCANS = 256  # --score-impl cmx / emx: JAX's kernel runs interpreted


def _port(argv, capsys):
    assert tcli.main(["--device", "cpu", *argv]) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _jax(argv, capsys):
    assert jcli.main(argv) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _traj(d):
    return np.load(os.path.join(d, "trajectory.npy"))


def _close(a, b, tol=TOL):
    dxy, dth = pose_error(np.asarray(a), np.asarray(b))
    assert max(dxy, dth) <= tol, (dxy, dth)


def _same_keys(a, b):
    assert set(a) == set(b), set(a) ^ set(b)


@pytest.fixture(scope="module")
def frontend_dirs(tmp_path_factory):
    """The frontend over the first 400 scans in both packages, with every
    output (--save-viz, --save-video)."""
    import contextlib
    import io

    base = tmp_path_factory.mktemp("frontend")
    out = {}
    for name, main, extra in (("port", tcli.main, ["--device", "cpu"]),
                              ("jax", jcli.main, [])):
        d = str(base / name)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert main([*extra, *SMALL, "--mode", "frontend",
                         "--scan-range", "0", "400", "--out", d,
                         "--save-viz", "--save-video",
                         os.path.join(d, "v.gif")]) == 0
        out[name] = (d, json.loads(buf.getvalue().strip().splitlines()[-1]))
    return out


def test_frontend_matches_jax(frontend_dirs):
    (d, m), (dj, mj) = frontend_dirs["port"], frontend_dirs["jax"]
    _same_keys(m, mj)
    assert m["scans"] == 400 and m["ate_m"] < m["ate_odom_m"]
    _close(_traj(d), _traj(dj))
    for f in ("trajectory.npy", "map_logodds.npy", "grid.json", "map.pgm",
              "map.yaml", "metrics.json", "metrics.jsonl", "map.png",
              "v.gif"):
        assert os.path.exists(os.path.join(d, f)), f
    with open(os.path.join(d, "grid.json")) as f, \
            open(os.path.join(dj, "grid.json")) as g:
        assert json.load(f) == json.load(g)
    assert m["video_frames"] == mj["video_frames"]


@pytest.mark.parametrize("how", ["yaml", "npy"])
def test_localize_matches_jax(frontend_dirs, capsys, how):
    d = frontend_dirs["port"][0]
    argv = [*SMALL, "--mode", "localize", "--scan-range", "0", "400"]
    if how == "yaml":
        argv += ["--map", os.path.join(d, "map.yaml"), "--global-init",
                 "--recover"]
    else:
        argv += ["--map", os.path.join(d, "map_logodds.npy")]
    outs = []
    for name, run in (("port", _port), ("jax", _jax)):
        o = os.path.join(d, f"loc_{how}_{name}")
        outs.append((run([*argv, "--out", o], capsys), _traj(o)))
    (m, tr), (mj, trj) = outs
    _same_keys(m, mj)
    _close(tr, trj)
    assert m["ate_m"] < m["ate_odom_m"]
    if how == "yaml":
        _close(np.asarray([m["global_init_pose"]]),
               np.asarray([mj["global_init_pose"]]))


@pytest.mark.parametrize("tiled", [False, True])
def test_full_matches_jax(tmp_path, capsys, tiled):
    argv = [*SMALL, "--mode", "full"]
    if tiled:
        argv += ["--tiled", "--tile-size", "128", "--tile-slots", "24",
                 "--scan-range", "0", "800"]
    runs = []
    for name, run in (("port", _port), ("jax", _jax)):
        o = str(tmp_path / name)
        runs.append((run([*argv, "--out", o], capsys), _traj(o)))
    (m, tr), (mj, trj) = runs
    _same_keys(m, mj)
    assert (m["n_keyframes"], m["n_loops"]) == (mj["n_keyframes"],
                                                mj["n_loops"])
    if not tiled:
        assert m["n_loops"] >= 1
    _close(tr, trj)
    assert os.path.exists(tmp_path / "port" / "map.pgm")


def test_fastslam_within_jax_bounds(tmp_path, capsys):
    argv = [*SMALL, "--mode", "fastslam", "--particles", "8",
            "--scan-range", "0", "256"]
    m = _port([*argv, "--out", str(tmp_path / "p")], capsys)
    mj = _jax(argv, capsys)
    _same_keys(m, mj)
    assert m["scans"] == 256
    assert 1.0 <= m["mean_n_eff"] <= 8.01
    assert np.isfinite(m["ate_m"])
    assert np.load(tmp_path / "p" / "map_logodds.npy").shape == (256, 256)


@pytest.mark.parametrize("mode", ["frontend", "full"])
def test_split_run_equals_single_run(tmp_path, capsys, mode):
    end, cut = (384, 192) if mode == "frontend" else (1264, 640)
    argv = [*SMALL, "--mode", mode]
    _port([*argv, "--scan-range", "0", str(end), "--out",
           str(tmp_path / "one")], capsys)
    ck = str(tmp_path / "ck")
    a = _port([*argv, "--scan-range", "0", str(cut), "--save-state", ck,
               "--out", str(tmp_path / "a")], capsys)
    b = _port([*argv, "--scan-range", str(cut), str(end), "--resume-state",
               ck, "--out", str(tmp_path / "b")], capsys)
    assert a["saved_state"] == ck and b["resumed_from"] == ck
    one = _traj(tmp_path / "one")
    if mode == "frontend":
        split = np.concatenate([_traj(tmp_path / "a"), _traj(tmp_path / "b")])
        np.testing.assert_allclose(split, one, atol=1e-4)
    else:
        m = json.loads((tmp_path / "one" / "metrics.json").read_text())
        assert (b["n_keyframes"], b["n_loops"]) == (m["n_keyframes"],
                                                     m["n_loops"])
        np.testing.assert_allclose(_traj(tmp_path / "b"), one[cut:],
                                   atol=1e-3)


def test_fastslam_bf16_state_resumes(tmp_path, capsys):
    argv = [*SMALL, "--mode", "fastslam", "--particles", "4",
            "--map-dtype", "bfloat16", "--update-impl", "pallas_hybrid"]
    ck = str(tmp_path / "ck")
    _port([*argv, "--scan-range", "0", "48", "--save-state", ck], capsys)
    m = _port([*argv, "--scan-range", "48", "96", "--resume-state", ck],
              capsys)
    assert m["resumed_from"] == ck and np.isfinite(m["ate_m"])


def test_carmen_and_json_logs_with_relations(tmp_path, capsys):
    """The synthetic log written by the port's writers as .clf and .json,
    each run through both CLIs' frontends; the .clf run scored against
    a relations file built from the ground truth."""
    _, log = default_log(SensorConfig(), step=0.05)
    log = {k: v[:200] for k, v in log.items()}
    clf, js = str(tmp_path / "log.clf"), str(tmp_path / "log.json")
    tcarmen.save_carmen_log(clf, log)
    tcarmen.save_json_log(js, log)
    gt = log["gt_poses"]
    rel = []
    for a, b in ((0, 150), (20, 120), (60, 199)):
        c, s = np.cos(gt[a, 2]), np.sin(gt[a, 2])
        d = gt[b, :2] - gt[a, :2]
        rel.append(f"{a:.6f} {b:.6f} {c * d[0] + s * d[1]:.9f} "
                   f"{-s * d[0] + c * d[1]:.9f} 0 0 0 "
                   f"{gt[b, 2] - gt[a, 2]:.9f}\n")
    (tmp_path / "rel.txt").write_text("".join(rel))
    common = ["--grid-size", "256", "--resolution", "0.1", "--chunk", "16",
              "--update-impl", "sparse", "--score-impl", "gather",
              "--mode", "frontend"]
    for path, extra in ((clf, ["--relations", str(tmp_path / "rel.txt")]),
                        (js, [])):
        outs = []
        for name, run in (("port", _port), ("jax", _jax)):
            o = str(tmp_path / f"{os.path.basename(path)}_{name}")
            outs.append((run(["--log", path, *common, *extra, "--out", o],
                             capsys), _traj(o)))
        (m, tr), (mj, trj) = outs
        _same_keys(m, mj)
        _close(tr, trj)
        if extra:
            assert m["relations_used"] == m["relations_total"] == 3
            for k in ("relations_trans_rmse_m", "relations_rot_rmse_rad"):
                assert abs(m[k] - mj[k]) <= TOL, k


@pytest.mark.parametrize("argv", [
    ["--score-impl", "mxu"], ["--score-impl", "mxu_int8"],
])
def test_unported_options_raise(argv):
    with pytest.raises(SystemExit, match="ROADMAP"):
        tcli.main(["--device", "cpu", "--log", "synth", *argv])


@pytest.mark.parametrize("impl", ["cmx", "emx"])
def test_correlation_scorers_match_jax(tmp_path, capsys, impl):
    """--score-impl cmx and emx (the correlation scorer, kernel 5's plain
    version here; JAX's Pallas kernel in interpret mode) in the frontend's
    match: the same JSON keys and the trajectory within the frontend
    parity's tolerance of JAX's."""
    argv = [*SMALL, "--score-impl", impl, "--mode", "frontend",
            "--scan-range", "0", str(CORR_SCANS)]
    m = _port([*argv, "--out", str(tmp_path / "p")], capsys)
    mj = _jax([*argv, "--out", str(tmp_path / "j")], capsys)
    _same_keys(m, mj)
    assert m["scans"] == CORR_SCANS
    _close(_traj(tmp_path / "p"), _traj(tmp_path / "j"))


def test_no_silent_cpu_fallback(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        tcli.main(["--log", "synth"])
