"""SE(3) Lie-group operations on batched 4x4 homogeneous matrices.

Port of orbslam2_tpu/geometry/se3.py. Poses are `[..., 4, 4]` float32
tensors; the tangent convention matches g2o: xi = (omega, upsilon),
rotation first, and optimizer updates are left-multiplicative:
T_new = exp(xi) @ T.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def from_Rt(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Build [...,4,4] from rotation [...,3,3] and translation [...,3]."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = R.expand(*batch, 3, 3)
    t = t.expand(*batch, 3)
    top = torch.cat([R, t[..., :, None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=R.dtype, device=R.device)
    return torch.cat([top, bottom.expand(*batch, 1, 4)], dim=-2)


def rotation(T: torch.Tensor) -> torch.Tensor:
    return T[..., :3, :3]


def translation(T: torch.Tensor) -> torch.Tensor:
    return T[..., :3, 3]


def inverse(T: torch.Tensor) -> torch.Tensor:
    Rt = rotation(T).transpose(-1, -2)
    return from_Rt(Rt, -torch.einsum("...ij,...j->...i", Rt, translation(T)))


def transform(T: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Apply [...,4,4] to points [...,3] (broadcasting over batch dims)."""
    return torch.einsum("...ij,...j->...i", rotation(T), p) + translation(T)


def hat(w: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix of [...,3]."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([z, -wz, wy], dim=-1),
            torch.stack([wz, z, -wx], dim=-1),
            torch.stack([-wy, wx, z], dim=-1),
        ],
        dim=-2,
    )


def _eye3_like(W: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=W.dtype, device=W.device).expand(W.shape)


def exp_so3(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: [...,3] -> [...,3,3]. Numerically safe near 0."""
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS * _EPS))
    W = hat(w)
    W2 = W @ W
    small = theta2 < 1e-8
    A = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    B = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2)
    return _eye3_like(W) + A[..., None, None] * W + B[..., None, None] * W2


def log_so3(R: torch.Tensor) -> torch.Tensor:
    """Inverse Rodrigues through the quaternion (stable at pi)."""
    q = to_quaternion(R)
    v = q[..., :3]
    w = q[..., 3]
    flip = torch.where(w < 0, -1.0, 1.0)
    v = v * flip[..., None]
    w = w * flip
    n = torch.linalg.vector_norm(v, dim=-1)
    angle = 2.0 * torch.atan2(n, w)
    scale = torch.where(
        n < 1e-6,
        2.0 / torch.clamp(w, min=_EPS),
        angle / torch.clamp(n, min=_EPS),
    )
    return v * scale[..., None]


def _left_jacobian(w: torch.Tensor) -> torch.Tensor:
    """SO(3) left Jacobian J_l(w): V matrix of the SE(3) exp."""
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS * _EPS))
    W = hat(w)
    W2 = W @ W
    small = theta2 < 1e-8
    B = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2)
    C = torch.where(
        small, 1.0 / 6.0 - theta2 / 120.0, (theta - torch.sin(theta)) / (theta2 * theta)
    )
    return _eye3_like(W) + B[..., None, None] * W + C[..., None, None] * W2


def _left_jacobian_inv(w: torch.Tensor) -> torch.Tensor:
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS * _EPS))
    W = hat(w)
    W2 = W @ W
    small = theta2 < 1e-8
    half = 0.5 * theta
    s = torch.sin(half)
    cot = torch.cos(half) / torch.where(torch.abs(s) < _EPS, _EPS, s)
    D = torch.where(small, 1.0 / 12.0 + theta2 / 720.0, (1.0 - half * cot) / theta2)
    return _eye3_like(W) - 0.5 * W + D[..., None, None] * W2


def exp(xi: torch.Tensor) -> torch.Tensor:
    """se(3) exp: xi = [...,6] (omega, upsilon) -> [...,4,4]."""
    w, u = xi[..., :3], xi[..., 3:]
    t = torch.einsum("...ij,...j->...i", _left_jacobian(w), u)
    return from_Rt(exp_so3(w), t)


def log(T: torch.Tensor) -> torch.Tensor:
    """SE(3) log: [...,4,4] -> [...,6] (omega, upsilon)."""
    w = log_so3(rotation(T))
    u = torch.einsum("...ij,...j->...i", _left_jacobian_inv(w), translation(T))
    return torch.cat([w, u], dim=-1)


def retract(T: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    """Left-multiplicative update used by all optimizers: exp(xi) @ T."""
    return exp(xi) @ T


def to_quaternion(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> quaternion (x, y, z, w), TUM trajectory order.
    Shepperd's method, branch-free via argmax over the four candidates."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def root(x):
        return torch.sqrt(torch.clamp(x, min=_EPS)) * 2.0

    s = root(tr + 1.0)
    cw = torch.stack([(m21 - m12) / s, (m02 - m20) / s, (m10 - m01) / s, 0.25 * s], -1)
    s = root(1.0 + m00 - m11 - m22)
    cx = torch.stack([0.25 * s, (m01 + m10) / s, (m02 + m20) / s, (m21 - m12) / s], -1)
    s = root(1.0 + m11 - m00 - m22)
    cy = torch.stack([(m01 + m10) / s, 0.25 * s, (m12 + m21) / s, (m02 - m20) / s], -1)
    s = root(1.0 + m22 - m00 - m11)
    cz = torch.stack([(m02 + m20) / s, (m12 + m21) / s, 0.25 * s, (m10 - m01) / s], -1)

    cands = torch.stack([cw, cx, cy, cz], dim=-2)
    scores = torch.stack([tr, m00, m11, m22], dim=-1)
    idx = torch.where(tr > 0, 0, torch.argmax(scores, dim=-1))
    q = torch.gather(cands, -2, idx[..., None, None].expand(*idx.shape, 1, 4))[..., 0, :]
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
