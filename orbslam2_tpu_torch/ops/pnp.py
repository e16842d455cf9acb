"""Hypothesis-parallel EPnP + RANSAC for relocalization.

Port of orbslam2_tpu/ops/pnp.py (reference src/PnPsolver.cpp, Lepetit's
EPnP inside the adaptive RANSAC loop of Tracking.cpp:1239-1334): every
hypothesis of every candidate keyframe is sampled, solved and scored at
once. Control-point PCA, the 12x12 null space, the three beta
approximations (L_6x10 subsystems), Gauss-Newton on the betas and Horn's
pose recovery are batched over any leading dimensions ([C, B] = candidates
x hypotheses in `pnp_ransac_from_hypotheses`); inlier scoring is one
[C, B, N] masked reduction.

Differences from the JAX package (the first fixes what the JAX package
leaves to its eigensolver; none changes the algorithm):
  * the PCA axes that place the control points take a fixed sign
    (`canonical_axes`), and a hypothesis's 4-dimensional null space a
    fixed basis (`_nullspace`), so that the CPU and the card solve alike.
    EPnP's answer depends on both at the noise level, and eigh leaves both
    to rounding: the JAX package's float32 answers on a 4-point
    hypothesis are its eigensolver's, and no other solver reproduces them;
  * float64 throughout: eigh of the 12x12 M^T M squares M's condition
    number, which the JAX package's float32 covers with
    precision="highest";
  * a hypothesis solves on its own 4 points, gathered by index, where the
    JAX package weights all N points with a one-hot union (a TPU
    workaround: scatters serialize there); zero-weight rows add nothing;
  * sampling is split from the solve: `sample_hypotheses` draws the
    Gumbel-top-4 indices from an explicit `torch.Generator`, and
    `pnp_ransac_from_hypotheses` takes them, so that two implementations
    can be fed the same hypotheses.

Nothing here raises on a degenerate hypothesis (fewer than 4 valid points,
repeated or collinear points): inverses and solves take the `_ex` variants
without error checks, a non-finite matrix is replaced before `eigh`/`svd`
and its results are set to NaN, and a NaN pose fails every inlier test, so
the hypothesis scores 0, as a NaN does in the JAX package.

Works in normalized image coordinates ((u - cx) / fx), so fu = fv = 1 and
uc = vc = 0 in the M matrix.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

# control-point difference pairs and the L-matrix column order
_PAIRS_I = (0, 0, 0, 1, 1, 2)
_PAIRS_J = (1, 2, 3, 2, 3, 3)
# columns of L map to quadratic monomials:
# [b11, b12, b22, b13, b23, b33, b14, b24, b34, b44]
_MONO = ((0, 0), (0, 1), (1, 1), (0, 2), (1, 2), (2, 2), (0, 3), (1, 3), (2, 3), (3, 3))
_MONO_A = tuple(a for a, _ in _MONO)
_MONO_C = tuple(c for _, c in _MONO)

F64 = torch.float64


def _eye(n, like):
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _finite(A: torch.Tensor):
    """(A with its non-finite matrices replaced by the identity, mask of the
    finite ones [...]) for eigh / svd, which raise on NaN or inf."""
    ok = torch.isfinite(A).all(dim=-1).all(dim=-1)
    return torch.where(ok[..., None, None], A, _eye(A.shape[-1], A)), ok


def _nan_where_not(ok: torch.Tensor, x: torch.Tensor, extra_dims: int) -> torch.Tensor:
    return torch.where(ok.reshape(ok.shape + (1,) * extra_dims), x, torch.nan)


def _eigh(A: torch.Tensor):
    """Ascending eigenvalues and eigenvectors of symmetric A [..., n, n];
    NaN for a matrix that was not finite."""
    A, ok = _finite(A)
    lam, V = torch.linalg.eigh(A)
    return _nan_where_not(ok, lam, 1), _nan_where_not(ok, V, 2)


def canonical_axes(V: torch.Tensor) -> torch.Tensor:
    """Eigenvectors (columns of V [..., n, n]) with the sign that makes each
    one's largest-magnitude component positive. EPnP's answer depends on
    the PCA axes' signs at the noise level (the control points move, and
    with them the algebraic error the null space minimizes), and eigh
    leaves the sign open: LAPACK and cuSOLVER differ. This fixes it."""
    top = torch.argmax(torch.abs(V), dim=-2, keepdim=True)
    return V * torch.where(torch.take_along_dim(V, top, dim=-2) < 0, -1.0, 1.0)


def _choose_control_points(pw, w):
    """Weighted centroid + PCA axes (reference PnPsolver.cpp:296-321):
    [..., 4, 3], largest axis first, each with `canonical_axes`' sign."""
    wsum = torch.clamp(w.sum(-1), min=1e-9)
    c0 = (pw * w[..., None]).sum(-2) / wsum[..., None]
    M = (pw - c0[..., None, :]) * torch.sqrt(w)[..., None]
    cov = M.transpose(-1, -2) @ M / wsum[..., None, None]
    lam, V = _eigh(cov)
    V = canonical_axes(V)
    lam = torch.clamp(lam, min=1e-12)
    axes = V.flip(-1) * torch.sqrt(lam.flip(-1))[..., None, :]
    return torch.cat([c0[..., None, :], c0[..., None, :] + axes.transpose(-1, -2)], dim=-2)


def _barycentric(pw, cws):
    """alphas [..., n, 4] with sum 1 (reference compute_barycentric_coordinates)."""
    CC = (cws[..., 1:, :] - cws[..., :1, :]).transpose(-1, -2)
    CCinv, _ = torch.linalg.inv_ex(CC + 1e-12 * _eye(3, CC))
    a123 = (pw - cws[..., :1, :]) @ CCinv.transpose(-1, -2)
    a0 = 1.0 - a123.sum(-1, keepdim=True)
    return torch.cat([a0, a123], dim=-1)


def _nullspace(alphas, obs, w):
    """The 4 smallest eigenvectors of M^T M as [..., 4, 4, 3]: 4 basis
    vectors x 4 control points."""
    u, v = obs[..., 0:1], obs[..., 1:2]
    zero = torch.zeros_like(alphas)
    n = alphas.shape[-2]
    lead = alphas.shape[:-2]
    row_u = torch.stack([alphas, zero, -alphas * u], dim=-1).reshape(*lead, n, 12)
    row_v = torch.stack([zero, alphas, -alphas * v], dim=-1).reshape(*lead, n, 12)
    sw = torch.sqrt(w)[..., None]
    M = torch.cat([row_u * sw, row_v * sw], dim=-2)
    _, V = _eigh(M.transpose(-1, -2) @ M)
    V4 = V[..., :, :4]
    # <= 4 weighted points (every RANSAC hypothesis): M has at most 8
    # nonzero rows, so the 4 smallest eigenvalues are all zero and eigh's
    # basis of that null space is set by rounding. Rotate it to the
    # eigenvectors of V4^T diag(1..12) V4, ascending, signed by
    # `canonical_axes`: a function of the subspace alone, so that the CPU
    # and the card solve each hypothesis alike.
    D = torch.arange(1, 13, dtype=V.dtype, device=V.device)
    _, U = _eigh(V4.transpose(-1, -2) @ (V4 * D[:, None]))
    V4c = canonical_axes(V4 @ U)
    degenerate = ((w > 0).sum(-1) <= 4)[..., None, None]
    V4 = torch.where(degenerate, V4c, V4)
    return V4.transpose(-1, -2).reshape(*lead, 4, 4, 3)


def _l6x10_rho(vs, cws):
    I, J = list(_PAIRS_I), list(_PAIRS_J)
    dv = vs[..., :, I, :] - vs[..., :, J, :]  # [..., 4, 6, 3]
    cols = []
    for a, b in _MONO:
        term = (dv[..., a, :, :] * dv[..., b, :, :]).sum(-1)
        cols.append(term if a == b else 2.0 * term)
    L = torch.stack(cols, dim=-1)  # [..., 6, 10]
    rho = ((cws[..., I, :] - cws[..., J, :]) ** 2).sum(-1)  # [..., 6]
    return L, rho


def _lstsq(A, b):
    AtA = A.transpose(-1, -2) @ A + 1e-9 * _eye(A.shape[-1], A)
    Atb = (A.transpose(-1, -2) @ b[..., None])[..., 0]
    x, _ = torch.linalg.solve_ex(AtA, Atb, check_errors=False)
    return x


def _betas_approx(L, rho):
    """The reference's three initializations (PnPsolver.cpp:520-647),
    stacked: [..., 3, 4] beta candidates."""
    zero = torch.zeros_like(rho[..., 0])
    # case 1: columns [b11, b12, b13, b14]
    x1 = _lstsq(L[..., [0, 1, 3, 6]], rho)
    b1 = torch.sqrt(torch.abs(x1[..., 0]))
    s1 = torch.where(x1[..., 0] < 0, -1.0, 1.0)
    d1 = torch.clamp(b1, min=1e-9)
    beta1 = torch.stack([b1, s1 * x1[..., 1] / d1, s1 * x1[..., 2] / d1, s1 * x1[..., 3] / d1], dim=-1)
    # case 2: columns [b11, b12, b22]
    x2 = _lstsq(L[..., [0, 1, 2]], rho)
    b21 = torch.sqrt(torch.abs(x2[..., 0]))
    b22 = torch.sqrt(torch.abs(x2[..., 2]))
    b22 = torch.where(x2[..., 1] < 0, -b22, b22)
    beta2 = torch.stack([b21, b22, zero, zero], dim=-1)
    # case 3: columns [b11, b12, b22, b13, b23]
    x3 = _lstsq(L[..., [0, 1, 2, 3, 4]], rho)
    b31 = torch.sqrt(torch.abs(x3[..., 0]))
    b32 = torch.sqrt(torch.abs(x3[..., 2]))
    b32 = torch.where(x3[..., 1] < 0, -b32, b32)
    b33 = x3[..., 3] / torch.clamp(b31, min=1e-9)
    beta3 = torch.stack([b31, b32, b33, zero], dim=-1)
    return torch.stack([beta1, beta2, beta3], dim=-2)


def _gauss_newton_betas(L, rho, betas, n_iter: int = 5):
    """Refine betas [..., 4] on the L b2 = rho system (PnPsolver.cpp:649-691)."""
    onehot = _eye(4, betas)
    Ea, Ec = onehot[list(_MONO_A)], onehot[list(_MONO_C)]  # [10, 4]
    a, c = list(_MONO_A), list(_MONO_C)
    for _ in range(n_iter):
        mono = betas[..., a] * betas[..., c]  # [..., 10]
        r = (L @ mono[..., None])[..., 0] - rho
        # d mono_k / d b_m = [m == a_k] b_c + [m == c_k] b_a
        Jm = Ea * betas[..., c, None] + Ec * betas[..., a, None]  # [..., 10, 4]
        betas = betas + _lstsq(L @ Jm, -r)
    return betas


def _pose_from_betas(betas, vs, alphas, pw, w):
    """Control points in the camera frame -> Horn alignment -> (R, t)
    (reference compute_ccs / compute_pcs / estimate_R_and_t)."""
    ccs = torch.einsum("...a,...aij->...ij", betas, vs)  # [..., 4, 3]
    pcs = alphas @ ccs  # [..., n, 3]
    # cheirality: camera-frame depths should be positive
    zsum = torch.where(w > 0, pcs[..., 2], 0.0).sum(-1)
    pcs = pcs * torch.where(zsum < 0, -1.0, 1.0)[..., None, None]
    wsum = torch.clamp(w.sum(-1), min=1e-9)[..., None]
    pc0 = (pcs * w[..., None]).sum(-2) / wsum
    pw0 = (pw * w[..., None]).sum(-2) / wsum
    H = ((pw - pw0[..., None, :]) * w[..., None]).transpose(-1, -2) @ (pcs - pc0[..., None, :])
    H, ok = _finite(H)
    U, _, Vt = torch.linalg.svd(H)
    U, Vt = _nan_where_not(ok, U, 2), _nan_where_not(ok, Vt, 2)
    V, Ut = Vt.transpose(-1, -2), U.transpose(-1, -2)
    d = torch.sign(torch.linalg.det(V @ Ut))
    D = torch.diag_embed(torch.stack([torch.ones_like(d), torch.ones_like(d), d], dim=-1))
    R = V @ D @ Ut
    t = pc0 - (R @ pw0[..., None])[..., 0]
    return R, t


def _project(R, t, pw):
    """(uv [..., n, 2], z [..., n]) of world points under (R, t), with the
    JAX package's guard on |z| < 1e-9."""
    pc = pw @ R.transpose(-1, -2) + t[..., None, :]
    z = torch.where(torch.abs(pc[..., 2]) < 1e-9, 1e-9, pc[..., 2])
    return pc[..., :2] / z[..., None], z


def _reproj_err2(R, t, pw, obs, w):
    uv, _ = _project(R, t, pw)
    e2 = ((uv - obs) ** 2).sum(-1)
    return torch.where(w > 0, e2, 0.0).sum(-1) / torch.clamp(w.sum(-1), min=1e-9)


def epnp_solve(pw, obs, w):
    """Weighted EPnP over any leading dimensions: pw [..., n, 3] world
    points, obs [..., n, 2] normalized image coordinates, w [..., n]
    weights (0 = ignore). Returns (R [..., 3, 3], t [..., 3], mean squared
    reprojection error [...]) in float64, the best of the three beta
    initializations."""
    pw, obs, w = pw.to(F64), obs.to(F64), w.to(F64)
    cws = _choose_control_points(pw, w)
    alphas = _barycentric(pw, cws)
    vs = _nullspace(alphas, obs, w)
    L, rho = _l6x10_rho(vs, cws)
    betas = _gauss_newton_betas(L[..., None, :, :], rho[..., None, :], _betas_approx(L, rho))  # [..., 3, 4]
    Rs, ts = _pose_from_betas(betas, vs[..., None, :, :, :], alphas[..., None, :, :],
                              pw[..., None, :, :], w[..., None, :])
    errs = _reproj_err2(Rs, ts, pw[..., None, :, :], obs[..., None, :, :], w[..., None, :])
    best = torch.argmin(errs, dim=-1)  # [...]; a NaN error wins, as in jnp.argmin
    R = torch.take_along_dim(Rs, best[..., None, None, None], dim=-3)[..., 0, :, :]
    t = torch.take_along_dim(ts, best[..., None, None], dim=-2)[..., 0, :]
    return R, t, torch.take_along_dim(errs, best[..., None], dim=-1)[..., 0]


class PnPResult(NamedTuple):
    R: torch.Tensor  # [..., 3, 3] float64
    t: torch.Tensor  # [..., 3] float64
    inliers: torch.Tensor  # [..., N] bool
    n_inliers: torch.Tensor  # [...] int64


def sample_hypotheses(valid: torch.Tensor, n_hyp: int, generator: torch.Generator) -> torch.Tensor:
    """[..., n_hyp, 4] int64 point indices per hypothesis: Gumbel-top-4 over
    the valid points of valid [..., N] (the JAX package's draw, pnp.py:
    208-212, from `generator` on valid's device). With fewer than 4 valid
    points the rest come from the invalid ones, which weigh 0."""
    shape = valid.shape[:-1] + (n_hyp, valid.shape[-1])
    u = torch.rand(shape, generator=generator, dtype=torch.float32, device=valid.device)
    u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
    g = -torch.log(-torch.log(u)) + torch.where(valid, 0.0, -1e9)[..., None, :]
    return torch.topk(g, 4, dim=-1).indices


def _inliers(R, t, pw, obs, valid, max_err2):
    uv, z = _project(R, t, pw)
    e2 = ((uv - obs) ** 2).sum(-1)
    return (e2 < max_err2) & valid & (z > 0)


def pnp_ransac_from_hypotheses(idx, pw, obs, valid, max_err2) -> PnPResult:
    """RANSAC on given hypotheses: idx [C, B, 4] point indices, pw [C, N, 3]
    world points, obs [N, 2] normalized coordinates, valid [C, N], max_err2
    [N] per-point chi2 gate in normalized units. Solves each hypothesis's
    EPnP, scores all points against all hypotheses, refines on the best
    hypothesis's inliers and keeps the raw best where the refinement loses
    support (reference iterate + Refine, PnPsolver.cpp:102-268). Returns a
    `PnPResult` per candidate."""
    C, B, _ = idx.shape
    N = pw.shape[1]
    pw, obs, max_err2 = pw.to(F64), obs.to(F64), max_err2.to(F64)
    idx = idx.long()
    flat = idx.reshape(C, B * 4)
    pw4 = torch.gather(pw, 1, flat[..., None].expand(C, B * 4, 3)).reshape(C, B, 4, 3)
    w4 = torch.gather(valid, 1, flat).reshape(C, B, 4).to(F64)
    Rs, ts, _ = epnp_solve(pw4, obs[idx], w4)  # [C, B, 3, 3], [C, B, 3]

    # a hypothesis is 4 valid points (with fewer, the JAX package's draw
    # takes invalid ones, whose weight 0 leaves its float32 solve
    # degenerate, and the reference has no minimal set)
    full = (w4 > 0).all(-1)
    inl = _inliers(Rs, ts, pw[:, None], obs, valid[:, None, :], max_err2) & full[..., None]  # [C, B, N]
    counts = inl.sum(-1)
    best = torch.argmax(counts, dim=-1)  # first of the best, as jnp.argmax
    inl_best = torch.take_along_dim(inl, best[:, None, None], dim=1)[:, 0]
    R_best = torch.take_along_dim(Rs, best[:, None, None, None], dim=1)[:, 0]
    t_best = torch.take_along_dim(ts, best[:, None, None], dim=1)[:, 0]
    n_best = torch.take_along_dim(counts, best[:, None], dim=1)[:, 0]

    R, t, _ = epnp_solve(pw, obs.expand(C, N, 2), inl_best.to(F64))
    # no supported hypothesis, no pose: nothing to refine
    inliers = _inliers(R, t, pw, obs, valid, max_err2) & (n_best > 0)[:, None]
    better = inliers.sum(-1) >= n_best
    R = torch.where(better[:, None, None], R, R_best)
    t = torch.where(better[:, None], t, t_best)
    inliers = torch.where(better[:, None], inliers, inl_best)
    return PnPResult(R=R, t=t, inliers=inliers, n_inliers=inliers.sum(-1))


def pnp_ransac(pw, obs, valid, max_err2, generator: torch.Generator, n_hyp: int = 256) -> PnPResult:
    """Hypothesis-parallel RANSAC per candidate: `n_hyp` Gumbel-top-4
    hypotheses over each candidate's valid points, then
    `pnp_ransac_from_hypotheses`. Shapes as there."""
    idx = sample_hypotheses(valid, n_hyp, generator)
    return pnp_ransac_from_hypotheses(idx, pw, obs, valid, max_err2)
