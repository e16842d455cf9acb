"""Monocular map initialization: parallel homography / fundamental RANSAC.

Port of orbslam2_tpu/ops/initializer.py (the upstream Initializer,
src/Initializer.cc): two models are scored over the same batched 8-point
hypotheses,

  * H21 by the weighted normalized DLT, scored by the symmetric transfer
    error (chi2 5.991 both ways),
  * F21 by the normalized 8-point algorithm with rank 2 enforced, scored
    by the epipolar distances (chi2 3.84, score cap 5.991),

then RH = SH / (SH + SF) > 0.40 picks the homography, the motion is
recovered (Faugeras' 8 candidates for H, the 4 of E = K^T F K for F) by
triangulating every match under each candidate and counting the points in
front of both views with parallax and low reprojection error, and the
winner is accepted when it beats the second best clearly (< 0.75x), has
>= 50 points and a parallax cos < 0.99996.

Differences from the JAX package (none changes the algorithm):
  * float64 throughout (the JAX package solves in float32), as the port's
    other solvers do, so that the card and the CPU agree;
  * a hypothesis solves on its own 8 points, gathered by index, where the
    JAX package weights all N points with a one-hot union (a TPU
    workaround); zero-weight rows add nothing;
  * sampling is split from the solve: `initialize_two_view` draws the
    Gumbel-top-8 indices from the caller's `torch.Generator`
    (`pnp.sample_hypotheses`) and `initialize_two_view_from_hypotheses`
    takes them, so that two implementations can be fed the same ones;
  * F's overall sign, which eigh leaves open, is fixed before E is
    decomposed (`pnp.canonical_axes` on its flattened entries). The
    candidate sets of both decompositions do not depend on the SVD's
    signs, only their order does, and the winner is a geometric solution:
    compare the chosen T21, never a candidate's index.
Nothing syncs the host: the model choice and the acceptance are tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry import triangulation
from ..geometry.camera import Camera
from . import pnp

CHI2_H = 5.991
CHI2_F = 3.84
SCORE_CAP = 5.991
F64 = torch.float64


class InitResult(NamedTuple):
    success: torch.Tensor  # [] bool
    used_homography: torch.Tensor  # [] bool
    T21: torch.Tensor  # [4, 4] float64: frame 2's pose with frame 1 as the world
    points: torch.Tensor  # [N, 3] float64, frame-1 coordinates
    point_ok: torch.Tensor  # [N] bool: triangulated under the winner and passing its gates
    inliers: torch.Tensor  # [N] bool: the chosen model's inliers


def _K(cam: Camera, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor([[cam.fx, 0.0, cam.cx], [0.0, cam.fy, cam.cy], [0.0, 0.0, 1.0]],
                        dtype=like.dtype, device=like.device)


def _normalize_points(uv, w):
    """Weighted Hartley normalization of uv [..., n, 2] with weights w
    [..., n]: (normalized uv, T [..., 3, 3])."""
    wsum = torch.clamp(w.sum(-1), min=1e-9)[..., None]
    mean = (uv * w[..., None]).sum(-2) / wsum
    d = uv - mean[..., None, :]
    mean_dev = (torch.abs(d) * w[..., None]).sum(-2) / wsum
    s = 1.0 / torch.clamp(mean_dev, min=1e-9)
    uv_n = d * s[..., None, :]
    zero, one = torch.zeros_like(s[..., 0]), torch.ones_like(s[..., 0])
    T = torch.stack([
        torch.stack([s[..., 0], zero, -mean[..., 0] * s[..., 0]], -1),
        torch.stack([zero, s[..., 1], -mean[..., 1] * s[..., 1]], -1),
        torch.stack([zero, zero, one], -1),
    ], -2)
    return uv_n, T


def _smallest_eigvec(A):
    """The eigenvector of A^T A [..., 9, 9] with the smallest eigenvalue."""
    _, V = pnp._eigh(A.transpose(-1, -2) @ A)
    return V[..., :, 0]


def _solve_h(uv1, uv2, w):
    """Weighted DLT homography x2 ~ H x1 (reference ComputeH21) over any
    leading dimensions, normalized to H[2, 2] = 1."""
    n1, T1 = _normalize_points(uv1, w)
    n2, T2 = _normalize_points(uv2, w)
    u1, v1, u2, v2 = n1[..., 0], n1[..., 1], n2[..., 0], n2[..., 1]
    z, o = torch.zeros_like(u1), torch.ones_like(u1)
    r1 = torch.stack([z, z, z, -u1, -v1, -o, v2 * u1, v2 * v1, v2], -1)
    r2 = torch.stack([u1, v1, o, z, z, z, -u2 * u1, -u2 * v1, -u2], -1)
    A = torch.cat([r1 * w[..., None], r2 * w[..., None]], dim=-2)
    Hn = _smallest_eigvec(A).reshape(*A.shape[:-2], 3, 3)
    H, _ = torch.linalg.solve_ex(T2, Hn @ T1, check_errors=False)
    h22 = H[..., 2, 2]
    return H / torch.where(torch.abs(h22) < 1e-12, 1e-12, h22)[..., None, None]


def _solve_f(uv1, uv2, w):
    """Weighted normalized 8-point fundamental matrix (reference ComputeF21)
    with rank 2 enforced, over any leading dimensions."""
    n1, T1 = _normalize_points(uv1, w)
    n2, T2 = _normalize_points(uv2, w)
    u1, v1, u2, v2 = n1[..., 0], n1[..., 1], n2[..., 0], n2[..., 1]
    A = torch.stack([u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1, torch.ones_like(u1)], -1) * w[..., None]
    Fn, ok = pnp._finite(_smallest_eigvec(A).reshape(*A.shape[:-2], 3, 3))
    U, S, Vh = torch.linalg.svd(Fn)
    S = torch.cat([S[..., :2], torch.zeros_like(S[..., 2:])], dim=-1)
    Fn = pnp._nan_where_not(ok, (U * S[..., None, :]) @ Vh, 2)
    return T2.transpose(-1, -2) @ Fn @ T1


def _homogeneous(a):
    return torch.cat([a, torch.ones_like(a[..., :1])], dim=-1)


def _score_h(H, uv1, uv2, valid, sigma2: float = 1.0):
    """Symmetric transfer error scoring (reference CheckHomography) of H
    [..., 3, 3] on every match: (score [...], inliers [..., N])."""
    Hinv, _ = torch.linalg.inv_ex(H)

    def transfer(M, a):
        b = _homogeneous(a) @ M.transpose(-1, -2)
        z = b[..., 2:3]
        return b[..., :2] / torch.where(torch.abs(z) < 1e-12, 1e-12, z)

    e12 = ((uv1 - transfer(Hinv, uv2)) ** 2).sum(-1) / sigma2
    e21 = ((uv2 - transfer(H, uv1)) ** 2).sum(-1) / sigma2
    ok = (e12 < CHI2_H) & (e21 < CHI2_H) & valid
    score = torch.where(valid & (e12 < CHI2_H), CHI2_H - e12, 0.0) + torch.where(
        valid & (e21 < CHI2_H), CHI2_H - e21, 0.0)
    return score.sum(-1), ok


def _score_f(F, uv1, uv2, valid, sigma2: float = 1.0):
    """Epipolar distance scoring (reference CheckFundamental) of F
    [..., 3, 3] on every match: (score [...], inliers [..., N])."""
    h1, h2 = _homogeneous(uv1), _homogeneous(uv2)
    l2 = h1 @ F.transpose(-1, -2)  # epipolar lines in image 2
    l1 = h2 @ F  # lines in image 1
    d2 = ((h2 * l2).sum(-1) ** 2) / torch.clamp(l2[..., 0] ** 2 + l2[..., 1] ** 2, min=1e-12) / sigma2
    d1 = ((h1 * l1).sum(-1) ** 2) / torch.clamp(l1[..., 0] ** 2 + l1[..., 1] ** 2, min=1e-12) / sigma2
    ok = (d1 < CHI2_F) & (d2 < CHI2_F) & valid
    score = torch.where(valid & (d2 < CHI2_F), SCORE_CAP - d2, 0.0) + torch.where(
        valid & (d1 < CHI2_F), SCORE_CAP - d1, 0.0)
    return score.sum(-1), ok


def _candidate_poses_from_f(F, cam: Camera):
    """E = K^T F K -> 4 (R, t) candidates (reference DecomposeE), F's sign
    fixed first."""
    F = pnp.canonical_axes(F.reshape(9, 1)).reshape(3, 3)
    K = _K(cam, F)
    E, ok = pnp._finite(K.T @ F @ K)
    U, _, Vh = torch.linalg.svd(E)
    U, Vh = pnp._nan_where_not(ok, U, 2), pnp._nan_where_not(ok, Vh, 2)
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], dtype=F.dtype, device=F.device)
    R1 = U @ W @ Vh
    R1 = R1 * torch.sign(torch.linalg.det(R1))
    R2 = U @ W.T @ Vh
    R2 = R2 * torch.sign(torch.linalg.det(R2))
    t = U[:, 2]
    t = t / torch.clamp(torch.linalg.vector_norm(t), min=1e-12)
    return torch.stack([R1, R1, R2, R2]), torch.stack([t, -t, t, -t])


def _candidate_poses_from_h(H, cam: Camera):
    """Faugeras' SVD decomposition of the calibrated homography -> 8 (R, t)
    candidates (reference ReconstructH): 4 for d' = +d2, 4 for d' = -d2."""
    K = _K(cam, H)
    A, _ = torch.linalg.solve_ex(K, H @ K, check_errors=False)
    A, ok = pnp._finite(A)
    U, S, Vh = torch.linalg.svd(A)
    U, S, Vh = pnp._nan_where_not(ok, U, 2), pnp._nan_where_not(ok, S, 1), pnp._nan_where_not(ok, Vh, 2)
    d1, d2, d3 = S[0], S[1], S[2]
    s = torch.linalg.det(U) * torch.linalg.det(Vh)
    den13 = torch.clamp(d1 * d1 - d3 * d3, min=1e-12)
    aux1 = torch.sqrt(torch.clamp(d1 * d1 - d2 * d2, min=0.0) / den13)
    aux3 = torch.sqrt(torch.clamp(d2 * d2 - d3 * d3, min=0.0) / den13)
    signs1 = torch.tensor([1.0, 1.0, -1.0, -1.0], dtype=H.dtype, device=H.device)
    signs3 = torch.tensor([1.0, -1.0, 1.0, -1.0], dtype=H.dtype, device=H.device)
    x1, x3 = signs1 * aux1, signs3 * aux3  # [4]
    # the sign of x1 * x3 (Faugeras' case analysis)
    sgn = x1 * x3 / torch.clamp(torch.abs(x1 * x3), min=1e-30)
    root = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), min=0.0))
    zero4, one4 = torch.zeros_like(x1), torch.ones_like(x1)

    def cands(sin, cos, mid, a, b, c, scale):
        # Rp = [[cos, 0, a sin], [0, mid, 0], [sin, 0, b cos]] and
        # tp = (x1, 0, c x3) scale, one per sign case: [4, 3, 3], [4, 3]
        Rp = torch.stack([
            torch.stack([cos * one4, zero4, a * sin], -1),
            torch.stack([zero4, mid * one4, zero4], -1),
            torch.stack([sin, zero4, b * cos * one4], -1),
        ], -2)
        tp = torch.stack([x1, zero4, c * x3], -1) * scale
        R = s * U @ Rp @ Vh
        t = tp @ U.T
        return R, t / torch.clamp(torch.linalg.vector_norm(t, dim=-1, keepdim=True), min=1e-12)

    # d' = +d2: the sine carries the sign of x1 * x3
    sin_t = sgn * root / torch.clamp((d1 + d3) * d2, min=1e-12)
    cos_t = (d2 * d2 + d1 * d3) / torch.clamp((d1 + d3) * d2, min=1e-12)
    Rp_, tp_ = cands(sin_t, cos_t, 1.0, -1.0, 1.0, -1.0, d1 - d3)
    # d' = -d2
    sin_p = sgn * root / torch.clamp((d1 - d3) * d2, min=1e-12)
    cos_p = (d1 * d3 - d2 * d2) / torch.clamp((d1 - d3) * d2, min=1e-12)
    Rm_, tm_ = cands(sin_p, cos_p, -1.0, 1.0, -1.0, 1.0, d1 + d3)
    return torch.cat([Rp_, Rm_]), torch.cat([tp_, tm_])


def _check_rt(R, t, uv1, uv2, inliers, cam: Camera, sigma2: float = 1.0):
    """Triangulate every match under each candidate (R [C, 3, 3], t [C, 3])
    and keep the points in front of both views with parallax cos < 0.99998
    and reprojection error^2 < 4 sigma2 in both (reference CheckRT).
    Returns (count [C], good [C, N], X [C, N, 3], parallax cos [C]: the
    51st smallest of the good points', or of all if fewer)."""
    xn1 = torch.stack([(uv1[:, 0] - cam.cx) / cam.fx, (uv1[:, 1] - cam.cy) / cam.fy], -1)
    xn2 = torch.stack([(uv2[:, 0] - cam.cx) / cam.fx, (uv2[:, 1] - cam.cy) / cam.fy], -1)
    P1 = torch.eye(4, dtype=R.dtype, device=R.device)[:3]
    P2 = torch.cat([R, t[:, :, None]], dim=-1)[:, None]  # [C, 1, 3, 4]
    X, ok = triangulation.triangulate_dlt(P1, P2, xn1, xn2)  # [C, N, 3]
    z1 = X[..., 2]
    Xc2 = X @ R.transpose(-1, -2) + t[:, None, :]
    z2 = Xc2[..., 2]
    O2 = -(R.transpose(-1, -2) @ t[..., None])[..., 0]
    par = triangulation.rays_parallax_cos(torch.zeros_like(O2)[:, None], O2[:, None], X)

    def err2(Xc, z, uv):
        zs = torch.where(torch.abs(z) < 1e-9, 1e-9, z)
        u = cam.fx * Xc[..., 0] / zs + cam.cx
        v = cam.fy * Xc[..., 1] / zs + cam.cy
        return (u - uv[:, 0]) ** 2 + (v - uv[:, 1]) ** 2

    good = (inliers & ok & (z1 > 0) & (z2 > 0) & (par < 0.99998)
            & (err2(X, z1, uv1) < 4.0 * sigma2) & (err2(Xc2, z2, uv2) < 4.0 * sigma2))
    count = good.sum(-1)
    par_sorted = torch.sort(torch.where(good, par, 1.0), dim=-1).values
    idx = torch.clamp(count - 1, min=0, max=50)
    return count, good, X, torch.gather(par_sorted, -1, idx[:, None])[:, 0]


def initialize_two_view_from_hypotheses(
    idx: torch.Tensor,  # [n_hyp, 8] match indices of each hypothesis
    uv1: torch.Tensor,  # [N, 2] matched keypoints in frame 1
    uv2: torch.Tensor,  # [N, 2] their matches in frame 2
    valid: torch.Tensor,  # [N] bool
    cam: Camera,
    min_parallax_cos: float = 0.99996,  # ~0.5 deg (reference minParallax = 1.0)
    min_triangulated: int = 50,
) -> InitResult:
    """Two-view initialization on given 8-point hypotheses (the JAX
    package's `initialize_two_view` after its draw)."""
    uv1, uv2 = uv1.to(F64), uv2.to(F64)
    idx = idx.long()
    w = valid[idx].to(F64)  # [B, 8]: a sample's invalid points weigh 0
    Hs = _solve_h(uv1[idx], uv2[idx], w)
    Fs = _solve_f(uv1[idx], uv2[idx], w)
    sh, okh = _score_h(Hs, uv1, uv2, valid)
    sf, okf = _score_f(Fs, uv1, uv2, valid)
    bh, bf = torch.argmax(sh), torch.argmax(sf)  # first of the best, as jnp.argmax
    SH, SF = sh[bh], sf[bf]
    use_h = SH / torch.clamp(SH + SF, min=1e-9) > 0.40  # reference model selection

    Rs_h, ts_h = _candidate_poses_from_h(Hs[bh], cam)
    Rs_f, ts_f = _candidate_poses_from_f(Fs[bf], cam)
    # F's 4 candidates padded to 8 so that both branches share one check
    Rs = torch.where(use_h, Rs_h, torch.cat([Rs_f, Rs_f]))
    ts = torch.where(use_h, ts_h, torch.cat([ts_f, ts_f]))
    inliers = torch.where(use_h, okh[bh], okf[bf])
    counts, goods, Xs, pars = _check_rt(Rs, ts, uv1, uv2, inliers, cam)
    # the F branch's slots 4-7 are copies: masked, or the distinctness test
    # would be defeated by the duplicates
    slot_ok = torch.arange(8, device=counts.device) < torch.where(use_h, 8, 4)
    counts = torch.where(slot_ok, counts, -1)
    best = torch.argmax(counts)
    n_best = counts[best]
    second = torch.sort(counts).values[-2]
    distinct = second.to(F64) < 0.75 * n_best.to(F64)
    success = distinct & (n_best >= min_triangulated) & (pars[best] < min_parallax_cos)
    T21 = torch.eye(4, dtype=F64, device=Rs.device)
    T21[:3, :3], T21[:3, 3] = Rs[best], ts[best]
    return InitResult(success=success, used_homography=use_h, T21=T21, points=Xs[best], point_ok=goods[best],
                      inliers=inliers)


def initialize_two_view(uv1, uv2, valid, cam: Camera, generator: torch.Generator, n_hyp: int = 200,
                        min_parallax_cos: float = 0.99996, min_triangulated: int = 50) -> InitResult:
    """Two-view initialization: `n_hyp` Gumbel-top-8 hypotheses over the
    valid matches, drawn from `generator` on its own device (a CPU
    generator draws the same hypotheses whatever device the matches are
    on), then `initialize_two_view_from_hypotheses`."""
    idx = pnp.sample_hypotheses(valid.to(generator.device), n_hyp, generator, k=8).to(valid.device)
    return initialize_two_view_from_hypotheses(idx, uv1, uv2, valid, cam, min_parallax_cos, min_triangulated)
