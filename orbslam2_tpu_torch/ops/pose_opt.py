"""Motion-only pose optimization: Levenberg-Marquardt on SE(3), and kernel K5.

Port of orbslam2_tpu/ops/pose_opt.py (reference Optimizer::
PoseOptimization, src/Optimizer.cpp:205-424): all edges evaluated in
batch (residual + analytic Jacobian), the 6x6 normal system, LM
accept/reject with g2o's lambda heuristics, 4 rounds x 10 iterations,
every round restarting from the initial pose with the inliers
reclassified by chi2, Huber in rounds 0-2. Mono edges are stereo edges
whose third residual component is masked out.

`pose_optimize` is the wrapper: on CPU tensors it runs the plain version,
`pose_optimize_plain`; on CUDA tensors it makes ONE launch of the
hand-written kernel `csrc/pose_lm.cu`, which runs the whole schedule in
one thread-block cluster (`K5_CLUSTER` CTAs, each on a slice of the edges)
and writes the pose, the inlier mask and the inlier count on the device
(no host sync). Both compute the same float64 math in the same steps:

  * per edge, the residual r, the Jacobian rows K_c = [pc x a_c, a_c]
    (J = -K, a_c the row of d(u, v, uR)/dpc) and the weight;
  * the sums F, H (its 21 unique entries) and g = sum K^T W (-r);
  * on the host (the plain version) or one warp of each CTA (the kernel),
    the damped 6x6 solve (x = 0 where a pivot is <= 0 or NaN, what
    `cholesky_ex`'s info != 0 gave), the retract exp(dx) @ T
    (geometry/se3.py, its small-angle branch included), g2o's rho test
    and the lambda/nu update.

They differ only in the order of the float64 sums, in contracted
multiply-adds, in the last bits of sin and cos, and in the kernel's
square-root-free Cholesky (L D L^T, the same pivots) with reciprocals
where the plain version divides.
"""

from __future__ import annotations

import ctypes
import math
import threading
from typing import NamedTuple

import torch

from ..geometry.camera import Camera
from ..kernels import build

CHI2_MONO = 5.991
CHI2_STEREO = 7.815
DELTA_MONO = 2.447864292  # sqrt(5.991)
DELTA_STEREO = 2.795531836  # sqrt(7.815)


class PoseOptResult(NamedTuple):
    Tcw: torch.Tensor  # [4,4] optimized pose
    inlier: torch.Tensor  # [N] bool (valid and not chi2-outlier)
    n_inliers: torch.Tensor  # scalar int32


class _Edges(NamedTuple):
    """The float64 edge data of one problem, and its per-edge constants."""

    pw: torch.Tensor  # [N,3]
    obs: torch.Tensor  # [N,3]
    inv_sigma2: torch.Tensor  # [N]
    cm: torch.Tensor  # [N,3] component mask (1, 1, is_stereo)
    delta: torch.Tensor  # [N] Huber width
    delta2: torch.Tensor  # [N]
    chi2_th: torch.Tensor  # [N]
    f: torch.Tensor  # [2] (fx, fy)
    c: torch.Tensor  # [2] (cx, cy)


def _project(T, e: _Edges, cam: Camera):
    """pc [N,3], 1/z (z clamped away from 0) [N], r = obs - h(pc) [N,3] for
    the 3x4 pose T (float64 tensor) and the stereo measurement
    h = (u, v, u - bf/z)."""
    pc = torch.addmm(T[:, 3], e.pw, T[:, :3].T)
    z = pc[:, 2]
    iz = torch.where(torch.abs(z) < 1e-6, 1e-6, z).reciprocal()
    uv = pc[:, :2] * e.f * iz[:, None] + e.c  # fx * x * iz + cx
    r = e.obs - torch.cat([uv, (uv[:, 0] - cam.bf * iz)[:, None]], dim=1)
    return pc, iz, r


def _chi2(r, e: _Edges):
    """Unrobustified per-edge chi2 = r^T Omega r with Omega = invSigma2*I."""
    return torch.sum(r * r * e.cm, dim=-1) * e.inv_sigma2


def _terms(T, e: _Edges, active, use_huber: bool, cam: Camera):
    """F and the 7x7 M = sum over edges and components of W k k^T, with
    k = (K_c, -r_c): H = M[:6, :6], g = M[:6, 6]."""
    pc, iz, r = _project(T, e, cam)
    x, y = pc[:, 0], pc[:, 1]
    e2 = _chi2(r, e)
    robust = (e2 > e.delta2) if use_huber else torch.zeros_like(active)
    sq = torch.sqrt(torch.clamp(e2, min=1e-12))
    w_act = active & (pc[:, 2] > 0.0)
    F = torch.sum(torch.where(w_act, torch.where(robust, 2.0 * e.delta * sq - e.delta2, e2), 0.0))
    w = torch.where(w_act, torch.where(robust, e.delta / sq, 1.0) * e.inv_sigma2, 0.0)
    fiz, iz2, zero = cam.fx * iz, iz * iz, torch.zeros_like(iz)
    a = torch.stack([fiz, zero, -cam.fx * x * iz2,
                     zero, cam.fy * iz, -cam.fy * y * iz2,
                     fiz, zero, (cam.bf - cam.fx * x) * iz2], dim=-1).view(-1, 3, 3)
    k = torch.cat([torch.linalg.cross(pc[:, None, :].expand(-1, 3, -1), a, dim=-1), a, -r[:, :, None]], dim=-1)
    kw = (k * (w[:, None] * e.cm)[:, :, None]).view(-1, 7)
    return F, kw.T @ k.view(-1, 7)


def _solve6(A, b):
    """x with A x = b for the 6x6 A (lower triangle read), float64 nested
    lists: 0 where a pivot is <= 0 or NaN (when H = 0, no active edge, b
    = g = 0 too)."""
    L = [[0.0] * 6 for _ in range(6)]
    for j in range(6):
        s = A[j][j]
        for k in range(j):
            s -= L[j][k] * L[j][k]
        if not s > 0.0:
            return [0.0] * 6
        L[j][j] = math.sqrt(s)
        for i in range(j + 1, 6):
            s = A[i][j]
            for k in range(j):
                s -= L[i][k] * L[j][k]
            L[i][j] = s / L[j][j]
    y = [0.0] * 6
    for i in range(6):
        s = b[i]
        for k in range(i):
            s -= L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [0.0] * 6
    for i in reversed(range(6)):
        s = y[i]
        for k in range(i + 1, 6):
            s -= L[k][i] * x[k]
        x[i] = s / L[i][i]
    return x


def _retract(T, dx):
    """exp(dx) @ T for the 3x4 pose T (rows), dx = (omega, upsilon):
    geometry/se3.py's `exp` (Rodrigues and the left Jacobian, with their
    theta2 < 1e-8 branches) in float64 scalars."""
    w0, w1, w2 = dx[0], dx[1], dx[2]
    theta2 = w0 * w0 + w1 * w1 + w2 * w2
    theta = math.sqrt(max(theta2, 1e-16))
    if theta2 < 1e-8:
        A = 1.0 - theta2 / 6.0
        B = 0.5 - theta2 / 24.0
        C = 1.0 / 6.0 - theta2 / 120.0
    else:
        s = math.sin(theta)
        A = s / theta
        B = (1.0 - math.cos(theta)) / theta2
        C = (theta - s) / (theta2 * theta)
    W = ((0.0, -w2, w1), (w2, 0.0, -w0), (-w1, w0, 0.0))
    W2 = [[W[i][0] * W[0][j] + W[i][1] * W[1][j] + W[i][2] * W[2][j] for j in range(3)] for i in range(3)]
    R = [[(i == j) + A * W[i][j] + B * W2[i][j] for j in range(3)] for i in range(3)]
    V = [[(i == j) + B * W[i][j] + C * W2[i][j] for j in range(3)] for i in range(3)]
    t = [V[i][0] * dx[3] + V[i][1] * dx[4] + V[i][2] * dx[5] for i in range(3)]
    return [[R[i][0] * T[0][j] + R[i][1] * T[1][j] + R[i][2] * T[2][j] + (t[i] if j == 3 else 0.0)
             for j in range(4)] for i in range(3)]


def _lm_optimize(T0, e: _Edges, active, cam: Camera, use_huber: bool, n_iters: int):
    """n_iters LM iterations from the 3x4 pose T0 (rows) over `active`
    edges. Returns the pose."""
    dev = e.pw.device

    def eval_at(T):
        F, M = _terms(torch.tensor(T, dtype=torch.float64, device=dev), e, active, use_huber, cam)
        v = torch.cat([M[:6].reshape(-1), F.reshape(1)]).tolist()
        return v[42], [v[7 * i:7 * i + 6] for i in range(6)], [v[7 * i + 6] for i in range(6)]

    F, H, g = eval_at(T0)
    T = T0
    lam = 1e-5 * max(H[i][i] for i in range(6))
    ni = 2.0
    for _ in range(n_iters):
        A = [[H[i][j] + (lam if i == j else 0.0) for j in range(6)] for i in range(6)]
        dx = [-x for x in _solve6(A, g)]
        T_new = _retract(T, dx)
        F_new, H_new, g_new = eval_at(T_new)
        # g2o rho denominator: dx^T (lam*dx + b), b = -g
        rho = (F - F_new) / (sum(d * (lam * d - gi) for d, gi in zip(dx, g)) + 1e-12)
        if rho > 0.0 and math.isfinite(F_new):
            T, F, H, g = T_new, F_new, H_new, g_new
            q = 2.0 * rho - 1.0
            lam *= max(1.0 - q * q * q, 1.0 / 3.0)
            ni = 2.0
        else:
            lam *= ni
            ni *= 2.0
    return T


def pose_optimize_plain(T0, pw, obs, inv_sigma2, is_stereo, valid, cam: Camera,
                        n_rounds: int = 4, n_iters: int = 10) -> PoseOptResult:
    """Plain version of K5: the 4-round schedule over N edges, the edge
    terms in batched float64 PyTorch and the 6x6 algebra on the host
    (a device read per LM pass). Arguments as `pose_optimize`."""
    out_dtype, dev = T0.dtype, T0.device
    f64 = torch.float64
    # the Huber widths and chi2 thresholds are float32, as the JAX package's
    delta = torch.where(is_stereo, DELTA_STEREO, DELTA_MONO).to(torch.float32)
    e = _Edges(
        pw=pw.to(f64), obs=obs.to(f64), inv_sigma2=inv_sigma2.to(f64),
        cm=torch.stack([torch.ones_like(is_stereo), torch.ones_like(is_stereo), is_stereo], -1).to(f64),
        delta=delta.to(f64), delta2=(delta * delta).to(f64),
        chi2_th=torch.where(is_stereo, CHI2_STEREO, CHI2_MONO).to(torch.float32).to(f64),
        f=torch.tensor([cam.fx, cam.fy], dtype=f64, device=dev),
        c=torch.tensor([cam.cx, cam.cy], dtype=f64, device=dev),
    )
    T0_rows = T0.to(f64)[:3].tolist()
    outlier = torch.zeros_like(valid)
    T_opt = T0_rows
    for round_idx in range(n_rounds):
        T_opt = _lm_optimize(T0_rows, e, valid & ~outlier, cam, round_idx < n_rounds - 1, n_iters)
        pc, _, r = _project(torch.tensor(T_opt, dtype=f64, device=dev), e, cam)
        outlier = valid & ((_chi2(r, e) > e.chi2_th) | ~(pc[:, 2] > 0.0))
    inlier = valid & ~outlier
    Tcw = torch.tensor(T_opt + [[0.0, 0.0, 0.0, 1.0]], dtype=f64, device=dev)
    return PoseOptResult(Tcw=Tcw.to(out_dtype), inlier=inlier, n_inliers=inlier.sum().to(torch.int32))


class _K5Args(ctypes.Structure):
    """`PoseLMArgs` of csrc/pose_lm.cu."""

    _fields_ = [
        ("T0", ctypes.c_void_p), ("pw", ctypes.c_void_p), ("obs", ctypes.c_void_p),
        ("inv_sigma2", ctypes.c_void_p), ("is_stereo", ctypes.c_void_p), ("valid", ctypes.c_void_p),
        ("Tcw", ctypes.c_void_p), ("inlier", ctypes.c_void_p), ("n_inliers", ctypes.c_void_p),
        ("fx", ctypes.c_double), ("fy", ctypes.c_double), ("cx", ctypes.c_double), ("cy", ctypes.c_double),
        ("bf", ctypes.c_double), ("n", ctypes.c_int), ("n_rounds", ctypes.c_int), ("n_iters", ctypes.c_int),
        ("cluster", ctypes.c_int),
    ]


#: CTAs of the cluster that runs one problem (csrc/pose_lm.cu: 1-16; above
#: 8 the launcher sets the non-portable cluster size attribute). 16 measured
#: faster than 8 on the main path's problems (PERF.md, kernel_device_ab.py)
K5_CLUSTER = 16


_count_lock = threading.Lock()


def pose_optimize(T0, pw, obs, inv_sigma2, is_stereo, valid, cam: Camera,
                  n_rounds: int = 4, n_iters: int = 10) -> PoseOptResult:
    """Full 4-round schedule over N edges: T0 [4,4], pw [N,3] world points,
    obs [N,3] (u, v, uR), inv_sigma2 [N], is_stereo [N], valid [N] (edge
    exists). CPU tensors take `pose_optimize_plain`; CUDA tensors (float32
    T0, pw, obs, inv_sigma2, bool masks) take one launch of K5, a cluster
    of `K5_CLUSTER` CTAs; a refused launch raises.

    The schedule runs in float64 (the reference's g2o is double) and
    returns a float32 pose: in float32, the LM's accept/reject test near
    convergence compares objective changes below the rounding noise of the
    objective itself, and a flipped decision there can move the final pose
    by millimetres."""
    dev = T0.device
    if dev.type == "cpu":
        return pose_optimize_plain(T0, pw, obs, inv_sigma2, is_stereo, valid, cam, n_rounds, n_iters)
    if dev.type != "cuda":
        raise ValueError(f"pose_optimize: unsupported device {dev}")
    N = pw.shape[0]
    want = {"T0": (T0, torch.float32, (4, 4)), "pw": (pw, torch.float32, (N, 3)),
            "obs": (obs, torch.float32, (N, 3)), "inv_sigma2": (inv_sigma2, torch.float32, (N,)),
            "is_stereo": (is_stereo, torch.bool, (N,)), "valid": (valid, torch.bool, (N,))}
    args = _K5Args(fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy, bf=cam.bf, n=N, n_rounds=n_rounds,
                   n_iters=n_iters, cluster=K5_CLUSTER)
    keep = []
    for name, (t, dtype, shape) in want.items():
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"pose_optimize: {name} must be {dtype} {shape} on {dev}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
        t = t.contiguous()
        keep.append(t)
        setattr(args, name, t.data_ptr())
    Tcw = torch.empty((4, 4), dtype=torch.float32, device=dev)
    inlier = torch.empty((N,), dtype=torch.bool, device=dev)
    n_inliers = torch.empty((), dtype=torch.int32, device=dev)
    args.Tcw, args.inlier, args.n_inliers = Tcw.data_ptr(), inlier.data_ptr(), n_inliers.data_ptr()
    build.launch("pose_lm_launch", args)
    with _count_lock:
        pose_optimize.launches += 1
    return PoseOptResult(Tcw=Tcw, inlier=inlier, n_inliers=n_inliers)


pose_optimize.launches = 0
