"""Trajectory error, numpy only: ATE after an optional SE(2) alignment,
the relative pose error, and the relative error against a Radish
relations file (the CARMEN benchmark's ground truth).

A copy of the JAX package's slam2d_tpu/metrics.py (align_se2, ate_rmse,
rpe_rmse, load_relations, rpe_relations).
"""

from __future__ import annotations

import numpy as np


def align_se2(est_xy: np.ndarray, gt_xy: np.ndarray):
    """Best-fit rotation R and translation t with gt ≈ R @ est + t."""
    mu_e = est_xy.mean(axis=0)
    mu_g = gt_xy.mean(axis=0)
    E = est_xy - mu_e
    G = gt_xy - mu_g
    H = E.T @ G
    U, _, Vt = np.linalg.svd(H)
    d = np.sign(np.linalg.det(Vt.T @ U.T))
    D = np.diag([1.0, d])
    R = Vt.T @ D @ U.T
    t = mu_g - R @ mu_e
    return R, t


def ate_rmse(est_poses: np.ndarray, gt_poses: np.ndarray, align: bool = True):
    """Absolute trajectory error (RMSE over xy) after SE(2) alignment."""
    est_xy = np.asarray(est_poses)[:, :2].astype(np.float64)
    gt_xy = np.asarray(gt_poses)[:, :2].astype(np.float64)
    if align:
        R, t = align_se2(est_xy, gt_xy)
        est_xy = est_xy @ R.T + t
    err = est_xy - gt_xy
    return float(np.sqrt((err**2).sum(axis=1).mean()))


def rpe_rmse(est_poses: np.ndarray, gt_poses: np.ndarray, delta: int = 1):
    """Relative pose error (RMSE of translational delta error)."""
    est = np.asarray(est_poses).astype(np.float64)
    gt = np.asarray(gt_poses).astype(np.float64)

    def rel(p):
        a, b = p[:-delta], p[delta:]
        c, s = np.cos(a[:, 2]), np.sin(a[:, 2])
        dx = b[:, 0] - a[:, 0]
        dy = b[:, 1] - a[:, 1]
        return np.stack([c * dx + s * dy, -s * dx + c * dy], axis=1)

    err = rel(est) - rel(gt)
    return float(np.sqrt((err**2).sum(axis=1).mean()))


def load_relations(path: str) -> np.ndarray:
    """Radish/Freiburg relations file: lines
    `t1 t2 x y z roll pitch yaw` — manually-verified relative poses
    between the scans at timestamps t1 and t2 (the Kuemmerle et al. 2009
    benchmark metric format the Intel/ACES/MIT-Killian logs ship with).
    Returns [N, 5] float64 rows (t1, t2, dx, dy, dyaw); comment lines
    and malformed rows are skipped."""
    rows = []
    with open(path, errors="replace") as f:
        for line in f:
            parts = line.split()
            if len(parts) < 8 or parts[0].startswith("#"):
                continue
            try:
                v = [float(p) for p in parts[:8]]
            except ValueError:
                continue
            rows.append((v[0], v[1], v[2], v[3], v[7]))
    if not rows:
        raise ValueError(f"no relations in {path}")
    return np.asarray(rows, np.float64)


def rpe_relations(
    est_poses: np.ndarray,
    stamps: np.ndarray,
    relations: np.ndarray,
    max_dt: float = 0.25,
):
    """Relative-pose error against a Radish relations file — the metric
    real CARMEN benchmarks are scored with (per-log ground truth exists
    only as these verified relative poses, not absolute trajectories).

    For each relation (t1, t2, dx, dy, dyaw): find the estimated poses
    whose timestamps are nearest t1/t2 (skip the relation if either is
    farther than max_dt seconds), compute the estimated relative pose
    X1^-1 X2, and accumulate the translational / angular deviation.

    Returns a dict: trans_rmse (m), rot_rmse (rad), n_used, n_total.
    """
    est = np.asarray(est_poses, np.float64)
    ts = np.asarray(stamps, np.float64)
    rel = np.asarray(relations, np.float64)
    # drop NaN-stamped poses (legacy rows without a ts field): NaN > max_dt
    # is False, so they would otherwise silently PASS the gate below
    n = min(len(est), len(ts))
    finite = np.isfinite(ts[:n])
    est = est[:n][finite]
    ts = ts[:n][finite]
    if len(ts) == 0:
        return {"trans_rmse": float("nan"), "rot_rmse": float("nan"),
                "n_used": 0, "n_total": len(rel)}
    order = np.argsort(ts)
    ts_s = ts[order]
    terr, rerr, used = [], [], 0
    for t1, t2, dx, dy, dyaw in rel:
        i1 = int(np.clip(np.searchsorted(ts_s, t1), 0, len(ts_s) - 1))
        i2 = int(np.clip(np.searchsorted(ts_s, t2), 0, len(ts_s) - 1))
        # searchsorted gives the right neighbor; check the left too
        if i1 > 0 and abs(ts_s[i1 - 1] - t1) < abs(ts_s[i1] - t1):
            i1 -= 1
        if i2 > 0 and abs(ts_s[i2 - 1] - t2) < abs(ts_s[i2] - t2):
            i2 -= 1
        if abs(ts_s[i1] - t1) > max_dt or abs(ts_s[i2] - t2) > max_dt:
            continue
        a = est[order[i1]]
        b = est[order[i2]]
        c, s = np.cos(a[2]), np.sin(a[2])
        d = b[:2] - a[:2]
        ex = c * d[0] + s * d[1] - dx
        ey = -s * d[0] + c * d[1] - dy
        eth = (b[2] - a[2] - dyaw + np.pi) % (2 * np.pi) - np.pi
        terr.append(ex * ex + ey * ey)
        rerr.append(eth * eth)
        used += 1
    if used == 0:
        return {"trans_rmse": float("nan"), "rot_rmse": float("nan"),
                "n_used": 0, "n_total": len(rel)}
    return {
        "trans_rmse": float(np.sqrt(np.mean(terr))),
        "rot_rmse": float(np.sqrt(np.mean(rerr))),
        "n_used": used,
        "n_total": len(rel),
    }
