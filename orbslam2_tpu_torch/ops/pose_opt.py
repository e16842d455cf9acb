"""Motion-only pose optimization: Levenberg-Marquardt on SE(3).

Port of orbslam2_tpu/ops/pose_opt.py (reference Optimizer::
PoseOptimization, src/Optimizer.cpp:205-424): all edges evaluated in
batch (residual + analytic Jacobian), the 6x6 normal system, LM
accept/reject with g2o's lambda heuristics, 4 rounds x 10 iterations,
every round restarting from the initial pose with the inliers
reclassified by chi2, Huber in rounds 0-2. Mono edges are stereo edges
whose third residual component is masked out.

Accept/reject is a `torch.where` on device tensors, so the whole schedule
runs without a host sync. This plain version is what runs on the card for
now; a single-launch kernel is the next item of the port's roadmap.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry import se3
from ..geometry.camera import Camera

CHI2_MONO = 5.991
CHI2_STEREO = 7.815
DELTA_MONO = 2.447864292  # sqrt(5.991)
DELTA_STEREO = 2.795531836  # sqrt(7.815)


class PoseOptResult(NamedTuple):
    Tcw: torch.Tensor  # [4,4] optimized pose
    inlier: torch.Tensor  # [N] bool (valid and not chi2-outlier)
    n_inliers: torch.Tensor  # scalar int32


def _residual_jacobian(Tcw, pw, obs, is_stereo, cam: Camera):
    """r = obs - h(Tcw @ pw) [N,3] and J = dr/dxi [N,3,6] for the stereo
    measurement h = (u, v, u - bf/z); dpc/dxi = [-[pc]x | I]."""
    pc = se3.transform(Tcw, pw)
    x, y, z = pc[:, 0], pc[:, 1], pc[:, 2]
    inv_z = 1.0 / torch.where(torch.abs(z) < 1e-6, 1e-6, z)
    inv_z2 = inv_z * inv_z

    u = cam.fx * x * inv_z + cam.cx
    v = cam.fy * y * inv_z + cam.cy
    ur = u - cam.bf * inv_z
    r = obs - torch.stack([u, v, ur], dim=-1)

    zero = torch.zeros_like(x)
    dh = torch.stack(
        [
            torch.stack([cam.fx * inv_z, zero, -cam.fx * x * inv_z2], -1),
            torch.stack([zero, cam.fy * inv_z, -cam.fy * y * inv_z2], -1),
            torch.stack([cam.fx * inv_z, zero, (-cam.fx * x + cam.bf) * inv_z2], -1),
        ],
        dim=-2,
    )  # [N,3,3]
    hat_pc = se3.hat(pc)
    eye = torch.eye(3, dtype=pc.dtype, device=pc.device).expand(hat_pc.shape)
    dpc = torch.cat([-hat_pc, eye], dim=-1)  # [N,3,6]
    J = -(dh @ dpc)
    comp_mask = torch.stack([torch.ones_like(x), torch.ones_like(x), is_stereo.to(pc.dtype)], -1)
    return r, J, comp_mask, z > 0.0


def _chi2(r, comp_mask, inv_sigma2):
    """Unrobustified per-edge chi2 = r^T Omega r with Omega = invSigma2*I."""
    return torch.sum(r * r * comp_mask, dim=-1) * inv_sigma2


def _solve6(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cholesky solve of the 6x6 system A x = b, without a host sync.

    The LM's A = H + lam*I is positive definite whenever H != 0 (lam =
    1e-5 max diag H > 0). When H = 0 (no active edge) the factorization
    fails and b = g = 0: x = 0 then, never NaN, which is what the JAX
    package's clamped pivots (sqrt(max(s, 1e-20))) give."""
    L, info = torch.linalg.cholesky_ex(A)
    x = torch.cholesky_solve(b[:, None], L)[:, 0]
    return torch.where(info == 0, x, 0.0)


def _lm_optimize(T0, pw, obs, inv_sigma2, is_stereo, active, cam, use_huber: bool, n_iters: int):
    """n_iters LM iterations from T0 over `active` edges. Returns T."""
    delta = torch.where(is_stereo, DELTA_STEREO, DELTA_MONO)
    delta2 = delta * delta
    eye6 = torch.eye(6, dtype=T0.dtype, device=T0.device)

    def eval_all(T):
        r, J, cm, depth_ok = _residual_jacobian(T, pw, obs, is_stereo, cam)
        e2 = _chi2(r, cm, inv_sigma2)
        robust = (e2 > delta2) if use_huber else torch.zeros_like(depth_ok)
        sq = torch.sqrt(torch.clamp(e2, min=1e-12))
        rho = torch.where(robust, 2.0 * delta * sq - delta2, e2)
        w_act = active & depth_ok
        F = torch.sum(torch.where(w_act, rho, 0.0))
        w_huber = torch.where(robust, delta / sq, 1.0)
        W = torch.where(w_act, w_huber * inv_sigma2, 0.0)[:, None] * cm  # [N,3]
        H = torch.einsum("nci,nc,ncj->ij", J, W, J)
        g = torch.einsum("nci,nc->i", J, W * r)
        return F, H, g

    F, H, g = eval_all(T0)
    T = T0
    lam = 1e-5 * torch.max(torch.diagonal(H))
    ni = torch.tensor(2.0, dtype=T0.dtype, device=T0.device)
    for _ in range(n_iters):
        dx = -_solve6(H + lam * eye6, g)
        T_new = se3.retract(T, dx)
        F_new, H_new, g_new = eval_all(T_new)
        # g2o rho denominator: dx^T (lam*dx + b), b = -g
        rho = (F - F_new) / (torch.dot(dx, lam * dx - g) + 1e-12)
        ok = (rho > 0.0) & torch.isfinite(F_new)
        lam_up = lam * ni
        lam_down = lam * torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3, min=1.0 / 3.0)
        T = torch.where(ok, T_new, T)
        F = torch.where(ok, F_new, F)
        H = torch.where(ok, H_new, H)
        g = torch.where(ok, g_new, g)
        lam = torch.where(ok, lam_down, lam_up)
        ni = torch.where(ok, 2.0, ni * 2.0)
    return T


def pose_optimize(T0, pw, obs, inv_sigma2, is_stereo, valid, cam: Camera,
                  n_rounds: int = 4, n_iters: int = 10) -> PoseOptResult:
    """Full 4-round schedule over N edges: pw [N,3] world points, obs [N,3]
    (u, v, uR), inv_sigma2 [N], is_stereo [N], valid [N] (edge exists).

    The schedule runs in float64 (the reference's g2o is double) and
    returns a float32 pose: in float32, the LM's accept/reject test near
    convergence compares objective changes below the rounding noise of the
    objective itself, and a flipped decision there can move the final pose
    by millimetres."""
    out_dtype = T0.dtype
    T0, pw, obs, inv_sigma2 = (x.to(torch.float64) for x in (T0, pw, obs, inv_sigma2))
    chi2_th = torch.where(is_stereo, CHI2_STEREO, CHI2_MONO)
    outlier = torch.zeros_like(valid)
    T_opt = T0
    for round_idx in range(n_rounds):
        active = valid & ~outlier
        T_opt = _lm_optimize(
            T0, pw, obs, inv_sigma2, is_stereo, active, cam,
            round_idx < n_rounds - 1, n_iters,
        )
        r, _, cm, depth_ok = _residual_jacobian(T_opt, pw, obs, is_stereo, cam)
        outlier = valid & ((_chi2(r, cm, inv_sigma2) > chi2_th) | ~depth_ok)
    inlier = valid & ~outlier
    return PoseOptResult(
        Tcw=T_opt.to(out_dtype), inlier=inlier, n_inliers=inlier.sum().to(torch.int32)
    )
