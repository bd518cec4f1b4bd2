"""CARMEN / JSON log loaders, numpy only.

A copy of the JAX package's slam2d_tpu/data/carmen.py (the two packages
read every file into the same arrays).

The reference preprocesses raw Radish CARMEN logs into per-dataset JSON with
records {x, y, theta, range[]}. We support both on the host:

- `load_carmen_log`: parses `FLASER` lines (which carry their own odometry
  fields; legacy pre-2000 rows fall back to the laser pose) and
  `ROBOTLASER1` lines from a raw CARMEN file. Standalone `ODOM` lines are
  ignored — every supported scan line carries its own pose.
- `load_json_log`: reads the reference's preprocessed-JSON shape — either a
  list of records or a dict keyed by timestamp with
  {"x", "y", "theta", "range": [...]} — tolerating a few common key spellings.

Output contract everywhere: dict of float32 arrays
  odom   [T, 3]   (x, y, theta) odometry pose per scan
  ranges [T, B]   raw ranges (not yet clipped; pipeline clips via SensorConfig)
"""

from __future__ import annotations

import json

import numpy as np


_NUM_CHARS = frozenset("0123456789+-.eE,")
_INT_CHARS = frozenset("0123456789+-")


def _int(v: str) -> int:
    """Strict integer token (Python int() accepts '1_000'; the C++
    grammar does not)."""
    if not v or not set(v) <= _INT_CHARS:
        raise ValueError(v)
    return int(v)


def _float(v: str) -> float:
    """Strict numeric-token float: plain decimals with an optional comma
    decimal separator (European-locale logs). Rejects 'nan'/'inf'/
    underscore-grouped tokens that Python float() accepts but the C++
    parser's digit grammar does not — the two loaders must make
    IDENTICAL keep/skip decisions per row (tests/test_torch_io.py
    holds them to it)."""
    if not v or not set(v) <= _NUM_CHARS:
        raise ValueError(v)
    try:
        return float(v)
    except ValueError:
        return float(v.replace(",", ".", 1))


def _parse_flaser(parts, n_beams):
    """One FLASER row -> (odom, ranges, n, stamp) or None.

    Standard (post-2000) format: `FLASER n r1..rn x y theta odom_x
    odom_y odom_theta ts host log_ts` — take the odometry fields.
    Legacy (pre-2000) rows carry only the laser pose: `FLASER n r1..rn
    x y theta ts host log_ts` — detected by the 3 fields after the pose
    failing to parse as floats (the `host` token lands where odom_theta
    would be); the laser pose is the best available odometry there.
    stamp = the ts field (NaN when absent) — the key the Radish
    relations files reference (metrics.load_relations)."""
    try:
        n = _int(parts[1])
        if n <= 0 or len(parts) < 2 + n + 3:
            return None
        if n_beams is not None and n != n_beams:
            return None
        ranges = [_float(v) for v in parts[2 : 2 + n]]
        pose = [_float(v) for v in parts[2 + n : 2 + n + 3]]
    except ValueError:
        return None
    ts_at = 2 + n + 3
    try:
        odom = [_float(v) for v in parts[2 + n + 3 : 2 + n + 6]]
        if len(odom) != 3:
            raise ValueError
        ts_at = 2 + n + 6
    except ValueError:
        odom = pose                     # legacy row: laser pose only
    try:
        stamp = _float(parts[ts_at])
    except (ValueError, IndexError):
        stamp = float("nan")
    return odom, ranges, n, stamp


def _parse_robotlaser1(parts, n_beams):
    """One ROBOTLASER1 row -> (odom, ranges, n, stamp) or None.

    Format: `ROBOTLASER1 laser_type start_angle fov angular_res max_range
    accuracy remission_mode num_readings r1..rn num_remissions rem..
    laser_x laser_y laser_theta robot_x robot_y robot_theta tv rv
    forward_safety side_safety turn_axis ts host log_ts` — take the
    ROBOT pose; stamp = ts (5 fields after the robot pose)."""
    try:
        n = _int(parts[8])
        if n <= 0 or len(parts) < 9 + n + 1:
            return None
        if n_beams is not None and n != n_beams:
            return None
        ranges = [_float(v) for v in parts[9 : 9 + n]]
        n_rem = _int(parts[9 + n])
        if n_rem < 0 or len(parts) < 10 + n + n_rem + 6:
            return None
        base = 10 + n + n_rem
        odom = [_float(v) for v in parts[base + 3 : base + 6]]
    except (ValueError, IndexError):
        return None
    try:
        stamp = _float(parts[base + 11])
    except (ValueError, IndexError):
        stamp = float("nan")
    return odom, ranges, n, stamp


def load_carmen_log(path: str):
    """Parse FLASER / ROBOTLASER1 entries from a raw CARMEN log file.

    Hardened against real-world Radish variance (SURVEY §10 item 5):
    pre-2000 FLASER rows without odometry fields (laser pose used),
    ROBOTLASER1 logs (robot pose used), `#` comments and PARAM lines
    (skipped), truncated final lines and non-numeric garbage (row
    dropped), comma decimal separators (accepted). Any malformed row is
    skipped — matching the C++ parser (data/native.py) bit for bit; the
    beam count latches from the first valid positive-count row only.
    """
    odoms, scans, stamps = [], [], []
    n_beams = None
    with open(path, errors="replace") as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "FLASER":
                row = _parse_flaser(parts, n_beams)
            elif parts[0] == "ROBOTLASER1":
                row = _parse_robotlaser1(parts, n_beams)
            else:
                continue
            if row is None:
                continue
            odom, ranges, n, stamp = row
            n_beams = n
            odoms.append(odom)
            scans.append(ranges)
            stamps.append(stamp)
    if not scans:
        raise ValueError(f"no FLASER/ROBOTLASER1 entries in {path}")
    return {
        "odom": np.asarray(odoms, dtype=np.float32),
        "ranges": np.asarray(scans, dtype=np.float32),
        # per-scan timestamps (the FLASER/ROBOTLASER1 ts field; NaN when
        # a row lacks one) — the Radish relations-file key
        # (metrics.rpe_relations)
        "stamps": np.asarray(stamps, dtype=np.float64),
    }


_XY_KEYS = (("x", "y", "theta"), ("x", "y", "t"), ("odom_x", "odom_y", "odom_theta"))
_RANGE_KEYS = ("range", "ranges", "scan", "readings")


def _record_to_row(rec: dict):
    for kx, ky, kt in _XY_KEYS:
        if kx in rec and ky in rec and kt in rec:
            pose = (float(rec[kx]), float(rec[ky]), float(rec[kt]))
            break
    else:
        raise KeyError(f"no pose keys in record: {sorted(rec)[:8]}")
    for kr in _RANGE_KEYS:
        if kr in rec:
            return pose, [float(v) for v in rec[kr]]
    raise KeyError(f"no range key in record: {sorted(rec)[:8]}")


def load_json_log(path: str):
    """Read a preprocessed JSON log (list of records, or dict keyed by
    time). Timestamps come from a per-record "timestamp"/"t"/"ts" field,
    or — the reference's dict shape — the numeric dict keys; NaN when
    neither exists, so `--relations` scoring works on preprocessed logs
    that kept their timing."""
    with open(path) as f:
        data = json.load(f)
    keys = None
    if isinstance(data, dict):
        if "map" in data and isinstance(data["map"], dict):
            data = data["map"]
        keys = sorted(data, key=_num_or_str)
        records = [data[k] for k in keys]
    else:
        records = data
    odoms, scans, stamps = [], [], []
    for i, rec in enumerate(records):
        pose, ranges = _record_to_row(rec)
        odoms.append(pose)
        scans.append(ranges)
        ts = float("nan")
        # NOT "t": that spelling is a THETA pose key (_XY_KEYS)
        for kt in ("timestamp", "ts", "time"):
            if isinstance(rec, dict) and kt in rec:
                try:
                    ts = float(rec[kt])
                    break
                except (TypeError, ValueError):
                    pass
        if np.isnan(ts) and keys is not None:
            try:
                ts = float(keys[i])
            except (TypeError, ValueError):
                pass
        stamps.append(ts)
    return {
        "odom": np.asarray(odoms, dtype=np.float32),
        "ranges": np.asarray(scans, dtype=np.float32),
        "stamps": np.asarray(stamps, dtype=np.float64),
    }


def _num_or_str(k):
    try:
        return (0, float(k))
    except (TypeError, ValueError):
        return (1, str(k))


def save_carmen_log(path: str, log: dict) -> str:
    """Write a {odom, ranges} log as CARMEN FLASER lines (the raw-log
    format load_carmen_log reads). The laser pose is written equal to the
    odometry pose, timestamps are synthetic."""
    odom = np.asarray(log["odom"], np.float64)
    ranges = np.asarray(log["ranges"], np.float64)
    n = ranges.shape[1]
    with open(path, "w") as f:
        for t in range(len(odom)):
            r = " ".join(f"{v:.6f}" for v in ranges[t])
            x, y, th = odom[t]
            pose = f"{x:.6f} {y:.6f} {th:.6f}"
            f.write(f"FLASER {n} {r} {pose} {pose} {float(t):.6f} synth {float(t):.6f}\n")
    return path


def save_json_log(path: str, log: dict) -> str:
    """Write a {odom, ranges} log in the reference's preprocessed-JSON
    shape (list of {x, y, theta, range} records) — the output format of
    the reference's DataPreprocess step."""
    odom = np.asarray(log["odom"], np.float64)
    ranges = np.asarray(log["ranges"], np.float64)
    stamps = np.asarray(
        log.get("stamps", np.arange(len(odom), dtype=np.float64))
    )
    records = [
        {
            "x": float(odom[t, 0]),
            "y": float(odom[t, 1]),
            "theta": float(odom[t, 2]),
            "range": [float(v) for v in ranges[t]],
            **({"timestamp": float(stamps[t])}
               if np.isfinite(stamps[t]) else {}),
        }
        for t in range(len(odom))
    ]
    with open(path, "w") as f:
        json.dump(records, f)
    return path


def carmen_to_json(path_in: str, path_out: str) -> str:
    """Preprocess a raw CARMEN log into the reference-style JSON log
    (the reference's DataPreprocess.py equivalent)."""
    return save_json_log(path_out, load_carmen_log(path_in))


def main(argv=None) -> int:
    """CLI: python -m slam2d_tpu_torch.data.carmen in.clf out.json"""
    import sys

    args = sys.argv[1:] if argv is None else argv
    if len(args) != 2:
        print("usage: python -m slam2d_tpu_torch.data.carmen IN.clf OUT.json")
        return 2
    carmen_to_json(args[0], args[1])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
