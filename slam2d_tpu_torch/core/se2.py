"""SE(2) pose algebra on [..., 3] (x, y, theta) tensors.

Port of slam2d_tpu/core/se2.py: the same closed forms in the same order of
float32 operations. theta is always wrapped to (-pi, pi].
"""

from __future__ import annotations

import math

import torch

_PI = math.pi
_TWO_PI = 2.0 * math.pi


def wrap_angle(theta):
    """Wrap to (-pi, pi]."""
    return torch.remainder(theta + _PI, _TWO_PI) - _PI


def compose(a, b):
    """a ⊕ b: apply pose b expressed in a's frame. Shapes broadcast."""
    ax, ay, ath = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bth = b[..., 0], b[..., 1], b[..., 2]
    c, s = torch.cos(ath), torch.sin(ath)
    return torch.stack(
        [ax + c * bx - s * by, ay + s * bx + c * by, wrap_angle(ath + bth)],
        dim=-1,
    )


def inverse(a):
    """a⁻¹ such that compose(a, inverse(a)) = identity."""
    ax, ay, ath = a[..., 0], a[..., 1], a[..., 2]
    c, s = torch.cos(ath), torch.sin(ath)
    return torch.stack(
        [-(c * ax + s * ay), -(-s * ax + c * ay), wrap_angle(-ath)], dim=-1
    )


def between(a, b):
    """a⁻¹ ⊕ b: pose of b expressed in a's frame (odometry delta)."""
    return compose(inverse(a), b)


def transform_points(pose, pts):
    """Apply pose ([..., 3]) to points ([..., N, 2]) in the pose frame."""
    x, y, th = pose[..., 0:1], pose[..., 1:2], pose[..., 2:3]
    c, s = torch.cos(th), torch.sin(th)
    px, py = pts[..., 0], pts[..., 1]
    return torch.stack([x + c * px - s * py, y + s * px + c * py], dim=-1)


def rotate_points(theta, pts):
    """Rotate points ([..., N, 2]) by theta ([...])."""
    c = torch.cos(theta)[..., None]
    s = torch.sin(theta)[..., None]
    px, py = pts[..., 0], pts[..., 1]
    return torch.stack([c * px - s * py, s * px + c * py], dim=-1)


def error_se2(xi, xj, zij):
    """Pose-graph edge error t2v(Z⁻¹ · (Xi⁻¹ · Xj))."""
    return between(zij, between(xi, xj))
