"""MLPnP: maximum-likelihood PnP over bearing vectors, batched.

Port of orbslam2_tpu/ops/mlpnp.py (reference MLPnPsolver, src/
MLPnPsolver.cpp, Urban et al. 2016; BASELINE config 4's relocalization
solver). Each observation is a unit bearing v with a 2D null-space basis
(r, s); a pose's residual is the transformed point's direction projected
onto that basis. The linear stage solves the 12-dof [R|t] system A x = 0
from the null-space rows and projects R onto SO(3) by SVD, giving 4
candidates ({x, -x} x {t, -t}); the one with the most points in front and
the best bearing agreement seeds Gauss-Newton on the 6-dof pose
(reference gauss_newton, MLPnPsolver.cpp:659-723). Everything is batched
over any leading dimensions: `mlpnp_ransac_from_hypotheses` solves every
6-point hypothesis at once.

Differences from the JAX package (none changes the algorithm):
  * float64 throughout (the JAX package solves in float32), as the port's
    other solvers do;
  * the null vector x of the linear stage takes a fixed sign
    (`pnp.canonical_axes`) before its two signs become candidates, so that
    the candidates come in the same order on the CPU and the card;
  * a hypothesis solves on its own 6 points, gathered by index, where the
    JAX package weights all N points with a one-hot union (a TPU
    workaround); zero-weight rows add nothing;
  * Gauss-Newton takes the residual's analytic Jacobian at the left
    perturbation xi = 0 (the JAX package differentiates the same residual
    with `jax.jacfwd`);
  * sampling is split from the solve: `mlpnp_ransac` draws the
    Gumbel-top-6 indices from the caller's `torch.Generator`
    (`pnp.sample_hypotheses`) and `mlpnp_ransac_from_hypotheses` takes
    them.
Nothing raises on a degenerate hypothesis, and nothing syncs the host.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry import se3
from . import pnp

F64 = torch.float64


def bearings_from_pixels(uv: torch.Tensor, fx, fy, cx, cy) -> torch.Tensor:
    """Pixels [..., 2] -> unit bearing vectors [..., 3]."""
    x = (uv[..., 0] - cx) / fx
    y = (uv[..., 1] - cy) / fy
    v = torch.stack([x, y, torch.ones_like(x)], dim=-1)
    return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)


def nullspace_basis(v: torch.Tensor):
    """Orthonormal (r, s) spanning the null space of each bearing [..., 3],
    built from the axis least aligned with v."""
    a = torch.zeros_like(v)
    x_ok = torch.abs(v[..., 0]) < 0.9
    a[..., 0] = torch.where(x_ok, 1.0, 0.0)
    a[..., 1] = torch.where(x_ok, 0.0, 1.0)
    r = torch.linalg.cross(v, a, dim=-1)
    r = r / torch.linalg.vector_norm(r, dim=-1, keepdim=True)
    s = torch.linalg.cross(v, r, dim=-1)
    s = s / torch.linalg.vector_norm(s, dim=-1, keepdim=True)
    return r, s


def _linear_stage(pw, r, s, w):
    """Solve A x = 0 for x = [rows of R | t] (12) from the weighted
    null-space rows; (R [..., 2, 3, 3], t [..., 2, 3]) for +x and -x (-R_raw
    projects to another rotation, so both signs are candidates)."""

    def rows(b):
        return torch.cat([b[..., 0:1] * pw, b[..., 1:2] * pw, b[..., 2:3] * pw, b], dim=-1)  # [..., n, 12]

    A = torch.cat([rows(r) * w[..., None], rows(s) * w[..., None]], dim=-2)
    _, V = pnp._eigh(A.transpose(-1, -2) @ A)
    x = pnp.canonical_axes(V[..., :, :1])[..., 0]  # [..., 12]
    xs = torch.stack([x, -x], dim=-2)  # [..., 2, 12]
    R_raw, ok = pnp._finite(xs[..., :9].reshape(*xs.shape[:-1], 3, 3))
    U, S, Vh = torch.linalg.svd(R_raw)
    U, S, Vh = pnp._nan_where_not(ok, U, 2), pnp._nan_where_not(ok, S, 1), pnp._nan_where_not(ok, Vh, 2)
    det = torch.linalg.det(U @ Vh)
    D = torch.diag_embed(torch.stack([torch.ones_like(det), torch.ones_like(det), det], dim=-1))
    R = U @ D @ Vh
    scale = 3.0 / torch.clamp(S.sum(-1), min=1e-12)  # undo the DLT's scale
    return R, xs[..., 9:] * scale[..., None]


def _unit(pc):
    return pc / torch.clamp(torch.linalg.vector_norm(pc, dim=-1, keepdim=True), min=1e-12)


def _transform(T, pw):
    return pw @ T[..., :3, :3].transpose(-1, -2) + T[..., None, :3, 3]


def _gauss_newton(T, pw, r, s, w, n_iter: int = 6):
    """Gauss-Newton on the weighted null-space residuals (r.u, s.u) of the
    transformed points' directions u, left-multiplicative updates."""
    eye3 = torch.eye(3, dtype=pw.dtype, device=pw.device)
    B = torch.stack([r, s], dim=-2)  # [..., n, 2, 3]
    for _ in range(n_iter):
        pc = _transform(T, pw)
        nrm = torch.clamp(torch.linalg.vector_norm(pc, dim=-1, keepdim=True), min=1e-12)
        u = pc / nrm
        e = (B @ u[..., None])[..., 0] * w[..., None]  # [..., n, 2]
        du = (eye3 - u[..., :, None] * u[..., None, :]) / nrm[..., None]  # d u / d pc
        dpc = torch.cat([-se3.hat(pc), eye3.expand(pc.shape[:-1] + (3, 3))], dim=-1)  # d pc / d (omega, upsilon)
        J = B @ du @ dpc * w[..., None, None]  # [..., n, 2, 6]
        H = torch.einsum("...nci,...ncj->...ij", J, J) + 1e-9 * torch.eye(6, dtype=pw.dtype, device=pw.device)
        g = torch.einsum("...nci,...nc->...i", J, e)
        dx, _ = torch.linalg.solve_ex(H, -g, check_errors=False)
        T = se3.retract(T, dx)
    return T


def mlpnp_solve(pw, bearings, w, n_gn: int = 6) -> torch.Tensor:
    """Weighted MLPnP over any leading dimensions: pw [..., n, 3] world
    points, bearings [..., n, 3], weights w [..., n] (0 = ignore). Returns
    Tcw [..., 4, 4] float64."""
    pw, bearings, w = pw.to(F64), bearings.to(F64), w.to(F64)
    r, s = nullspace_basis(bearings)
    Rs, ts = _linear_stage(pw, r, s, w)  # [..., 2, 3, 3], [..., 2, 3]
    # 4 candidates: {x, -x} projections x {t, -t}
    R4 = Rs.repeat_interleave(2, dim=-3)
    t4 = ts.repeat_interleave(2, dim=-2) * torch.tensor([1.0, -1.0, 1.0, -1.0], dtype=F64, device=pw.device)[:, None]
    cand = se3.from_Rt(R4, t4)  # [..., 4, 4, 4]
    pc = _transform(cand, pw[..., None, :, :])  # [..., 4, n, 3]
    w4 = w[..., None, :]
    align = ((_unit(pc) * bearings[..., None, :, :]).sum(-1) * w4).sum(-1)  # bearing agreement
    front = torch.where(w4 > 0, (pc[..., 2] > 0).to(F64), 0.0).sum(-1)
    best = torch.argmax(front * 10.0 + align, dim=-1)  # a NaN score wins, as in jnp.argmax
    T0 = torch.take_along_dim(cand, best[..., None, None, None], dim=-3)[..., 0, :, :]
    return _gauss_newton(T0, pw, r, s, w, n_gn)


class MLPnPResult(NamedTuple):
    Tcw: torch.Tensor  # [4, 4] float64
    inliers: torch.Tensor  # [N] bool
    n_inliers: torch.Tensor  # [] int64


def _inliers(T, pw, bearings, valid, cos_thresh):
    pc = _transform(T, pw)
    return ((_unit(pc) * bearings).sum(-1) > cos_thresh) & valid & (pc[..., 2] > 0)


def mlpnp_ransac_from_hypotheses(idx, pw, bearings, valid, cos_thresh) -> MLPnPResult:
    """RANSAC on given 6-point hypotheses (reference MLPnPsolver's RANSAC
    wrapper, MLPnPsolver.cpp:56-183): idx [B, 6] point indices, pw [N, 3]
    world points, bearings [N, 3], valid [N], cos_thresh [N] the least cos
    of the angle between a point's bearing and its prediction. Every
    hypothesis solved (4 Gauss-Newton steps) and scored, the best one's
    inliers refined (6 steps), the raw best kept where the refinement loses
    support."""
    pw, bearings, cos_thresh = pw.to(F64), bearings.to(F64), cos_thresh.to(F64)
    idx = idx.long()
    Ts = mlpnp_solve(pw[idx], bearings[idx], valid[idx].to(F64), n_gn=4)  # [B, 4, 4]
    inls = _inliers(Ts, pw, bearings, valid, cos_thresh)  # [B, N]
    counts = inls.sum(-1)
    best = torch.argmax(counts)  # first of the best, as jnp.argmax
    T = mlpnp_solve(pw, bearings, inls[best].to(F64))
    inl = _inliers(T, pw, bearings, valid, cos_thresh)
    better = inl.sum() >= counts[best]
    T = torch.where(better, T, Ts[best])
    inl = torch.where(better, inl, inls[best])
    return MLPnPResult(Tcw=T, inliers=inl, n_inliers=inl.sum())


def mlpnp_ransac(pw, bearings, valid, cos_thresh, generator: torch.Generator, n_hyp: int = 128) -> MLPnPResult:
    """`n_hyp` Gumbel-top-6 hypotheses over the valid points, drawn from
    `generator` on valid's device, then `mlpnp_ransac_from_hypotheses`."""
    idx = pnp.sample_hypotheses(valid, n_hyp, generator, k=6)
    return mlpnp_ransac_from_hypotheses(idx, pw, bearings, valid, cos_thresh)
