"""Trajectory error: ATE after an optional SE(2) alignment, numpy only.

A copy of the JAX package's slam2d_tpu/metrics.py (align_se2, ate_rmse).
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
