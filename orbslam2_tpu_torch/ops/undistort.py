"""Keypoint undistortion (reference Frame::UndistortKeyPoints,
src/Frame.cpp:471-503).

Port of orbslam2_tpu/ops/undistort.py: normalize, then the fixed-point
iteration of the inverse Brown-Conrady model (cv::undistortPoints's
scheme, 8 iterations), then back through K, as plain elementwise PyTorch
on the keypoints' device. The frontend applies it to the left keypoints
after stereo matching, only when the camera has a distortion coefficient.
"""

from __future__ import annotations

import torch


def _distort_normalized(x, y, k1, k2, p1, p2, k3):
    """The forward Brown-Conrady model on normalized coordinates."""
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return xd, yd


def undistort_points(uv: torch.Tensor, fx: float, fy: float, cx: float, cy: float, k1: float = 0.0,
                     k2: float = 0.0, p1: float = 0.0, p2: float = 0.0, k3: float = 0.0,
                     n_iters: int = 8) -> torch.Tensor:
    """Distorted pixel keypoints [..., 2] -> ideal pixel coordinates: the
    fixed point x = (x_obs - tangential(x)) / radial(x), `n_iters` times
    (OpenCV takes 5; 8 lands below 0.01 px for EuRoC/TUM-grade distortion)."""
    u = (uv[..., 0] - cx) / fx
    v = (uv[..., 1] - cy) / fy
    x, y = u, v
    for _ in range(n_iters):
        r2 = x * x + y * y
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        inv_r = 1.0 / torch.where(torch.abs(radial) < 1e-9, 1e-9, radial)
        x = (u - dx) * inv_r
        y = (v - dy) * inv_r
    return torch.stack([x * fx + cx, y * fy + cy], dim=-1)


def distort_points(uv: torch.Tensor, fx, fy, cx, cy, k1=0.0, k2=0.0, p1=0.0, p2=0.0, k3=0.0) -> torch.Tensor:
    """The forward distortion of ideal pixel points [..., 2] (for round trips)."""
    x = (uv[..., 0] - cx) / fx
    y = (uv[..., 1] - cy) / fy
    xd, yd = _distort_normalized(x, y, k1, k2, p1, p2, k3)
    return torch.stack([xd * fx + cx, yd * fy + cy], dim=-1)
