"""Sim3 solving for loop closure: batched Horn RANSAC and Sim3 refinement.

Port of orbslam2_tpu/ops/sim3solve.py (reference src/Sim3Solver.cpp, the
sequential 3-point RANSAC with Horn's quaternion closed form, and
Optimizer::OptimizeSim3, src/Optimizer.cpp:1054-1249):

  * `horn_sim3`: weighted Horn 1987 absolute orientation through the 4x4
    quaternion eigendecomposition, batched over any leading dimensions;
    scale closed-form or fixed to 1 (stereo, Sim3Solver.cpp:250);
  * `sim3_ransac`: every 3-point hypothesis solved and scored at once,
    inliers by reprojection in both images against 9.21 sigma^2;
  * `optimize_sim3`: LM on the 7-dof (6-dof with fixed scale) relative
    transform, Huber(th2 = 10) on both projection directions, prune and
    reoptimize.

Differences from the JAX package (none changes the algorithm):
  * float64 throughout (the JAX package solves in float32);
  * a hypothesis solves on its own 3 points, gathered by index, where the
    JAX package weights all N points with a one-hot union (a TPU
    workaround); zero-weight rows add nothing to Horn's sums;
  * sampling is split from the solve: `sim3_ransac` takes the [n_hyp, 3]
    hypothesis indices, or draws them (Gumbel-top-3, as the JAX package
    does from its key) from the caller's `torch.Generator`;
  * the quaternion is fixed where eigh leaves it open: in a degenerate top
    eigenspace (collinear points leave the rotation about their line
    free) the unit quaternion of that space nearest the identity, and
    otherwise the eigenvector's sign by `pnp.canonical_axes` (R does not
    depend on that sign), so that the card and the CPU solve alike;
  * the LM's Jacobian is `torch.func.jacfwd` of the same residual.
Nothing here syncs the host: the LM's accept/reject is `torch.where`.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..geometry import sim3
from ..geometry.camera import Camera
from . import pnp

F64 = torch.float64
#: eigenvalues within this share of the largest magnitude count as equal
DEGENERATE_REL = 1e-10


def from_quaternion(q: torch.Tensor) -> torch.Tensor:
    """Quaternion (x, y, z, w) [..., 4] -> rotation matrix [..., 3, 3]."""
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    x, y, z, w = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)], -1),
        torch.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)], -1),
        torch.stack([2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], -1),
    ], dim=-2)


def _top_quaternion(N: torch.Tensor) -> torch.Tensor:
    """(w, x, y, z) [..., 4]: the eigenvector of N's largest eigenvalue. In
    a degenerate top eigenspace, the projection of the identity (1, 0, 0,
    0) onto it, where that is not ~0."""
    lam, V = pnp._eigh(N)  # ascending; NaN where N was not finite
    V = pnp.canonical_axes(V)
    top = V[..., :, 3]
    tol = DEGENERATE_REL * torch.abs(lam).amax(-1)
    in_top = (lam[..., 3:4] - lam) <= tol[..., None]  # [..., 4]
    proj = (V * (in_top * V[..., 0, :])[..., None, :]).sum(-1)
    n = torch.linalg.vector_norm(proj, dim=-1, keepdim=True)
    use = (in_top.sum(-1, keepdim=True) > 1) & (n > 1e-6)
    return torch.where(use, proj / torch.clamp(n, min=1e-300), top)


def horn_sim3(P1: torch.Tensor, P2: torch.Tensor, w: torch.Tensor, fix_scale: bool) -> sim3.Sim3:
    """Weighted Horn alignment: (s, R, t) with P1 ~ s R P2 + t, for P1, P2
    [..., n, 3] camera-frame points and weights w [..., n] (reference
    Sim3Solver::ComputeSim3)."""
    wsum = torch.clamp(w.sum(-1), min=1e-9)
    O1 = (P1 * w[..., None]).sum(-2) / wsum[..., None]
    O2 = (P2 * w[..., None]).sum(-2) / wsum[..., None]
    Pr1 = (P1 - O1[..., None, :]) * w[..., None]
    Pr2 = P2 - O2[..., None, :]
    M = torch.einsum("...ni,...nj->...ij", Pr2, Pr1)
    m = lambda i, j: M[..., i, j]  # noqa: E731
    N11 = m(0, 0) + m(1, 1) + m(2, 2)
    N12 = m(1, 2) - m(2, 1)
    N13 = m(2, 0) - m(0, 2)
    N14 = m(0, 1) - m(1, 0)
    N22 = m(0, 0) - m(1, 1) - m(2, 2)
    N23 = m(0, 1) + m(1, 0)
    N24 = m(2, 0) + m(0, 2)
    N33 = -m(0, 0) + m(1, 1) - m(2, 2)
    N34 = m(1, 2) + m(2, 1)
    N44 = -m(0, 0) - m(1, 1) + m(2, 2)
    N = torch.stack([
        torch.stack([N11, N12, N13, N14], -1),
        torch.stack([N12, N22, N23, N24], -1),
        torch.stack([N13, N23, N33, N34], -1),
        torch.stack([N14, N24, N34, N44], -1),
    ], dim=-2)
    q = _top_quaternion(N)  # (w, x, y, z)
    R = from_quaternion(torch.cat([q[..., 1:], q[..., :1]], dim=-1))
    if fix_scale:
        s = torch.ones_like(wsum)
    else:
        # Horn's symmetric scale (the reference's asymmetric D/Sxx form
        # agrees at the optimum)
        num = (((P1 - O1[..., None, :]) ** 2) * w[..., None]).sum((-1, -2))
        den = ((Pr2**2) * w[..., None]).sum((-1, -2))
        s = torch.sqrt(num / torch.clamp(den, min=1e-12))
    t = O1 - s[..., None] * torch.einsum("...ij,...j->...i", R, O2)
    return sim3.Sim3(R=R, t=t, s=s)


def _project(cam: Camera, p: torch.Tensor):
    z = torch.where(torch.abs(p[..., 2]) < 1e-9, 1e-9, p[..., 2])
    return torch.stack([cam.fx * p[..., 0] / z + cam.cx, cam.fy * p[..., 1] / z + cam.cy], -1), z


class Sim3RansacResult(NamedTuple):
    S12: sim3.Sim3
    inliers: torch.Tensor  # [N] bool
    n_inliers: torch.Tensor  # [] int64


def _score(S: sim3.Sim3, X1, X2, uv1, uv2, max_err1, max_err2, valid, cam: Camera) -> torch.Tensor:
    """Inliers [..., N] of Sim3 S (batched over its leading dims): the
    reprojection of X2 into image 1 and of X1 into image 2 within their
    chi2 gates, both in front of the camera."""
    Sb = sim3.Sim3(R=S.R[..., None, :, :], t=S.t[..., None, :], s=S.s[..., None])
    S21 = sim3.inverse(Sb)
    p2in1, z1 = _project(cam, sim3.apply(Sb, X2))
    p1in2, z2 = _project(cam, sim3.apply(S21, X1))
    e1 = ((uv1 - p2in1) ** 2).sum(-1)
    e2 = ((uv2 - p1in2) ** 2).sum(-1)
    return (e1 < max_err1) & (e2 < max_err2) & valid & (z1 > 0) & (z2 > 0)


def sim3_ransac(X1, X2, uv1, uv2, max_err1, max_err2, valid, cam: Camera, fix_scale: bool = True,
                n_hyp: int = 128, hypotheses: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> Sim3RansacResult:
    """All 3-point hypotheses at once (reference Sim3Solver::iterate): X1,
    X2 [N, 3] matched points in each keyframe's camera frame, uv1, uv2
    [N, 2] their pixels, max_err1, max_err2 [N] 9.21 sigma^2 of their
    octaves, valid [N]. `hypotheses` [n_hyp, 3] point indices, or drawn
    from `generator`. Solves every hypothesis, takes the first with the
    most inliers, re-solves on its inliers and keeps that refinement
    unless it loses support."""
    X1, X2, uv1, uv2 = (a.to(F64) for a in (X1, X2, uv1, uv2))
    max_err1, max_err2 = max_err1.to(F64), max_err2.to(F64)
    if hypotheses is None:
        hypotheses = pnp.sample_hypotheses(valid, n_hyp, generator, k=3)
    idx = hypotheses.long()
    S = horn_sim3(X1[idx], X2[idx], valid[idx].to(F64), fix_scale)  # [B]
    inls = _score(S, X1, X2, uv1, uv2, max_err1, max_err2, valid, cam)  # [B, N]
    counts = inls.sum(-1)
    best = torch.argmax(counts)  # the first of the best, as jnp.argmax
    S_best = sim3.Sim3(*(a[best] for a in S))
    inl_best = inls[best]
    S_ref = horn_sim3(X1, X2, inl_best.to(F64), fix_scale)
    inl_ref = _score(S_ref, X1, X2, uv1, uv2, max_err1, max_err2, valid, cam)
    better = inl_ref.sum() >= counts[best]
    S_out = sim3.Sim3(*(torch.where(better, a, b) for a, b in zip(S_ref, S_best)))
    inliers = torch.where(better, inl_ref, inl_best)
    return Sim3RansacResult(S12=S_out, inliers=inliers, n_inliers=inliers.sum())


def optimize_sim3(S12: sim3.Sim3, X1, X2, uv1, uv2, inv_sigma2_1, inv_sigma2_2, valid, cam: Camera,
                  th2: float = 10.0, fix_scale: bool = True, n_iters: int = 10):
    """LM on the relative Sim3 (reference Optimizer::OptimizeSim3): paired
    edges e12 = uv1 - proj(S12 X2) and e21 = uv2 - proj(S12^-1 X1),
    Huber(sqrt(th2)), 5 iterations on `valid`, pairs with chi2 > th2 in
    either direction pruned, `n_iters` more. Returns (S12, inliers [N],
    n_inliers)."""
    S12 = S12.to(F64)
    X1, X2, uv1, uv2 = (a.to(F64) for a in (X1, X2, uv1, uv2))
    isq1, isq2 = torch.sqrt(inv_sigma2_1.to(F64)), torch.sqrt(inv_sigma2_2.to(F64))
    delta = th2**0.5
    n = X1.shape[0]
    eye7 = torch.eye(7, dtype=F64, device=X1.device)
    scale_lock = torch.ones(7, dtype=F64, device=X1.device)
    scale_lock[6] = 0.0

    def residuals(xi):
        S = sim3.retract(S12, xi)
        p2in1, _ = _project(cam, sim3.apply(S, X2))
        p1in2, _ = _project(cam, sim3.apply(sim3.inverse(S), X1))
        r = torch.cat([(uv1 - p2in1) * isq1[:, None], (uv2 - p1in2) * isq2[:, None]], dim=0)
        return r, r

    def huber(e2):
        return torch.where(e2 > th2, 2.0 * delta * torch.sqrt(torch.clamp(e2, min=1e-12)) - th2, e2)

    def total(xi, act2):
        r, _ = residuals(xi)
        return torch.where(act2, huber((r * r).sum(-1)), 0.0).sum()

    def system(xi, act2):
        J, r = torch.func.jacfwd(residuals, has_aux=True)(xi)  # [2N, 2, 7], [2N, 2]
        e2 = (r * r).sum(-1)
        w_h = torch.where(e2 > th2, delta / torch.sqrt(torch.clamp(e2, min=1e-12)), 1.0)
        w = torch.where(act2, w_h, 0.0)
        H = torch.einsum("nci,n,ncj->ij", J, w, J)
        g = torch.einsum("nci,n,nc->i", J, w, r)
        return H, g

    def chi2_pair(xi):
        r, _ = residuals(xi)
        e = (r * r).sum(-1)
        return e[:n], e[n:]

    def lm(active, xi, iters):
        act2 = torch.cat([active, active])
        H0, _ = system(xi, act2)
        lam = 1e-5 * torch.diagonal(H0).max() + 1e-12
        ni = torch.tensor(2.0, dtype=F64, device=xi.device)
        F = total(xi, act2)
        for _ in range(iters):
            H, g = system(xi, act2)
            if fix_scale:  # lock the log-scale coordinate
                lock = scale_lock[:, None] * scale_lock[None, :]
                H = H * lock + torch.diag(1.0 - scale_lock)
                g = g * scale_lock
            dx = -torch.linalg.solve_ex(H + lam * eye7, g)[0]
            xi_new = xi + dx
            F_new = total(xi_new, act2)
            rho = (F - F_new) / (torch.dot(dx, lam * dx - g) + 1e-12)
            ok = (rho > 0) & torch.isfinite(F_new)
            xi = torch.where(ok, xi_new, xi)
            F = torch.where(ok, F_new, F)
            lam = torch.where(ok, lam * torch.clamp(1 - (2 * rho - 1) ** 3, min=1 / 3), lam * ni)
            ni = torch.where(ok, 2.0, ni * 2.0)
        return xi

    xi = lm(valid, torch.zeros(7, dtype=F64, device=X1.device), 5)
    e12, e21 = chi2_pair(xi)
    keep = valid & (e12 <= th2) & (e21 <= th2)
    xi = lm(keep, xi, n_iters)
    e12, e21 = chi2_pair(xi)
    inlier = keep & (e12 <= th2) & (e21 <= th2)
    return sim3.retract(S12, xi), inlier, inlier.sum()
