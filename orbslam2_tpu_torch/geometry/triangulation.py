"""Batched two-view linear triangulation (the smallest eigenvector of the
DLT system).

Port of orbslam2_tpu/geometry/triangulation.py (reference
src/LocalMapping.cpp:292-320, the per-point SVD of the 4x4 DLT matrix):
x3D from the rays of two views through the eigenvector of A^T A with the
smallest eigenvalue, batched over any leading dimensions. The solve runs
in the inputs' dtype: float32 inputs solve in float32, as the JAX package
does; the two-view initializer passes float64. Its only user is the
monocular initializer (`ops/initializer.py`); the local mapper solves its
3x3 normal equations itself.
"""

from __future__ import annotations

import torch


def triangulate_dlt(P1: torch.Tensor, P2: torch.Tensor, xn1: torch.Tensor, xn2: torch.Tensor):
    """Triangulate normalized image points.

    P1, P2: [..., 3, 4] projection matrices ([R|t] for normalized
    coordinates); xn1, xn2: [..., 2] normalized coordinates ((u - cx) / fx,
    (v - cy) / fy). Leading dimensions broadcast. Returns (X [..., 3], ok
    [...]): ok is False where the eigenvector's homogeneous part is below
    1e-12 (a point at infinity). X does not depend on the eigenvector's
    sign."""
    rows = torch.broadcast_tensors(
        xn1[..., 0, None] * P1[..., 2, :] - P1[..., 0, :],
        xn1[..., 1, None] * P1[..., 2, :] - P1[..., 1, :],
        xn2[..., 0, None] * P2[..., 2, :] - P2[..., 0, :],
        xn2[..., 1, None] * P2[..., 2, :] - P2[..., 1, :],
    )
    A = torch.stack(rows, dim=-2)  # [..., 4, 4]
    AtA = A.transpose(-1, -2) @ A
    ok_in = torch.isfinite(AtA).all(-1).all(-1)
    eye = torch.eye(4, dtype=AtA.dtype, device=AtA.device)
    _, V = torch.linalg.eigh(torch.where(ok_in[..., None, None], AtA, eye))
    h = V[..., :, 0]
    w = h[..., 3]
    ok = (torch.abs(w) > 1e-12) & ok_in
    X = h[..., :3] / torch.where(ok, w, 1.0)[..., None]
    return X, ok


def rays_parallax_cos(O1: torch.Tensor, O2: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """cos of the parallax angle between the rays O1->X and O2->X
    (reference src/LocalMapping.cpp:274-289)."""
    r1 = X - O1
    r2 = X - O2
    n1 = torch.linalg.vector_norm(r1, dim=-1)
    n2 = torch.linalg.vector_norm(r2, dim=-1)
    return (r1 * r2).sum(-1) / torch.clamp(n1 * n2, min=1e-12)
