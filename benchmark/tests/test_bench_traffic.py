"""The frozen log generator against the program's copy, and the gates'
pass shares that define the mixes."""

import json

import numpy as np
import pytest

from benchmark import synth, traffic
from benchmark.bench import DATA

SENSOR = json.loads((DATA / "configs/frontend_1024.json").read_text())[
    "sensor"]
ROUTE = np.asarray(json.loads((DATA / "traffic/dense.json").read_text())[
    "route"])


@pytest.mark.parametrize("step,seed", [(0.05, 0), (0.05, 7), (0.35, 3),
                                       (0.35, 2**31 + 5)])
def test_frozen_generator_bit_for_bit(step, seed):
    from slam2d_tpu_torch.config import SensorConfig
    from slam2d_tpu_torch.data.synth import SynthWorld, simulate_log
    wp = np.concatenate([ROUTE, ROUTE]) if step > 0.1 else ROUTE
    a = simulate_log(SynthWorld.box_rooms(20.0), wp,
                     SensorConfig(n_beams=180, max_range=12.0), step=step,
                     odom_noise_xy=0.02, odom_noise_theta=0.004, seed=seed)
    b = synth.simulate_log(synth.SynthWorld.box_rooms(20.0), wp,
                           traffic.beam_angles(SENSOR), 12.0, step=step,
                           odom_noise_xy=0.02, odom_noise_theta=0.004,
                           seed=seed)
    for k in a:
        assert np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("mix", ["dense", "sparse"])
def test_session_length_fixed(mix):
    m = traffic.load_mix(mix)
    lens = {len(traffic.session_log(m, SENSOR, 64, s)["odom"])
            for s in (1, 2**31 + 11)}
    assert len(lens) == 1 and lens.pop() % 64 == 0


def _frontend_shares(log, fe):
    """The frontend's match and update gates over a log, on the host in
    float64, with the odometry standing in for the matched poses."""
    odom = log["odom"].astype(np.float64)
    dist, sm, sr, last = 0.0, 0.0, 0.0, odom[0]
    match = update = 0
    for t in range(1, len(odom)):
        d = odom[t] - odom[t - 1]
        step = float(np.hypot(d[0], d[1]))
        rot = abs((d[2] + np.pi) % (2 * np.pi) - np.pi)
        boot = dist < fe["bootstrap_dist"]
        sm, sr = sm + step, sr + rot
        if not boot and (sm >= fe["match_min_motion"]
                         or sr >= fe["match_min_rot"]):
            match += 1
            sm = sr = 0.0
        moved = float(np.hypot(*(odom[t, :2] - last[:2])))
        if boot or moved >= fe["map_update_min_motion"] or abs(
                (odom[t, 2] - last[2] + np.pi) % (2 * np.pi) - np.pi) >= \
                fe["map_update_min_rot"]:
            update += 1
            last = odom[t]
        dist += step
    n = len(odom) - 1
    return match / n, update / n


def _pf_shares(log, cfg):
    from slam2d_tpu_torch.pf.fastslam import host_gate_flags

    from benchmark.port import program_config
    flags = host_gate_flags(log["odom"], program_config(cfg), log["odom"][0],
                            0.0, np.inf, 0.0)
    return flags[:, 0].mean(), flags[:, 1].mean()


def test_gate_shares_sparse_above_dense():
    fe = json.loads((DATA / "configs/frontend_1024.json").read_text())
    pf = json.loads((DATA / "configs/fastslam100_512.json").read_text())
    shares = {}
    for mix in ("dense", "sparse"):
        m = traffic.load_mix(mix)
        m["laps"] = 1
        log = traffic.session_log(m, SENSOR, 1, 5)
        shares[mix] = (_frontend_shares(log, fe["frontend"])
                       + _pf_shares(log, pf))
    print("match, update, refine, pf update shares:", shares)
    d, s = shares["dense"], shares["sparse"]
    assert all(sv > dv for sv, dv in zip(s, d))
    # the dense mix: about 1/5 matched, 1/6 integrated, 1/3 refined
    assert 0.15 < d[0] < 0.25 and 0.12 < d[1] < 0.22
    assert 0.25 < d[2] < 0.40 and 0.12 < d[3] < 0.22
    assert min(s) > 0.9
