"""Bundle adjustment: Levenberg-Marquardt with block-Jacobi PCG.

Port of orbslam2_tpu/ops/ba.py: the point-major solver (:300-756), which
the system runs, and, at the end of this module, the edge-major (COO)
solver (:41-338, `ba_solve`) with its converter `coo_to_pm` (:350). The
point-major solver is used for the local bundle adjustment (reference Optimizer::LocalBundleAdjustment,
src/Optimizer.cpp:426-787) with the reference's two-stage schedule: 5 LM
iterations, the chi2 outlier cut (5.991 mono / 7.815 stereo), 10 more.

Layout: each of P point rows carries up to D observations [P, D]; padded
slots have `edge_valid` False and weigh nothing. Point-side sums run over
the D axis; camera-side sums are fp32 fixed-order segment sums over the
camera index of each edge (`segment_sum`), and the camera gather of the
H*v product is plain indexing.
(The JAX package does both as bf16 one-hot matmuls with f32 accumulation,
`_pm_onehot`/`_pm_mm`/`_pm_camera_gather`, because the TPU serializes
gathers and scatters; the port keeps the camera-side operand in fp32, so
its BA agrees with the JAX package's within a tolerance, not bit for bit.)

Every LM step stays on the tensors' device with no host sync: accept or
reject is a `torch.where`. A solve syncs once when it lays out the camera
segments, and `ba_solve_pm_interruptible` also where it reads
`float(state.F)` between chunks of iterations.

With a `reducer` (one shard of a mesh, `parallel/dist_ba.py`) the problem
holds this shard's point rows, and the sums over every point (the
camera-side gradient and blocks, the cost, the point halves of the PCG's
dot products, the largest point-block diagonal entry) go through
`reducer.sum` / `reducer.max`, where the JAX package psums over its mesh
axis (`axis_name`). Without one every result has the bits it had before
meshes were ported.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..geometry import se3
from ..geometry.camera import Camera

CHI2_MONO = 5.991
CHI2_STEREO = 7.815
DELTA_MONO = 2.447864292
DELTA_STEREO = 2.795531836


def inv3x3(M: torch.Tensor) -> torch.Tensor:
    """Batched closed-form 3x3 inverse (adjugate / det, det clamped to
    1e-18 in magnitude)."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    inv_det = 1.0 / torch.where(torch.abs(det) < 1e-18, 1e-18, det)
    adj = torch.stack(
        [
            torch.stack([A, -(b * i - c * h), b * f - c * e], -1),
            torch.stack([B, a * i - c * g, -(a * f - c * d)], -1),
            torch.stack([C, -(a * h - b * g), a * e - b * d], -1),
        ],
        dim=-2,
    )
    return adj * inv_det[..., None, None]


class BAProblemPM(NamedTuple):
    poses: torch.Tensor  # [K,4,4] float32 Tcw
    points: torch.Tensor  # [P,3] float32
    obs_kf: torch.Tensor  # [P,D] int64 camera row per slot
    obs: torch.Tensor  # [P,D,3] (u, v, uR)
    inv_sigma2: torch.Tensor  # [P,D]
    is_stereo: torch.Tensor  # [P,D] bool
    edge_valid: torch.Tensor  # [P,D] bool
    pose_fixed: torch.Tensor  # [K] bool


class PMLMState(NamedTuple):
    """LM state carried between iterations (0-dim tensors for lam, ni, F),
    so the host can run the solve in interruptible chunks."""

    poses: torch.Tensor
    points: torch.Tensor
    lam: torch.Tensor
    ni: torch.Tensor
    F: torch.Tensor


class BAResultPM(NamedTuple):
    poses: torch.Tensor
    points: torch.Tensor
    edge_inlier: torch.Tensor  # [P,D] bool
    final_chi2: torch.Tensor


def _pm_edge_terms(poses, points, prob: BAProblemPM, cam: Camera):
    """Residuals r [P,D,3], Jacobians Jc [P,D,3,6] (pose, left update) and
    Jp [P,D,3,3] (point), the residual components that count comp [P,D,3]
    (uR only for stereo edges) and z > 0 [P,D]."""
    T = poses[prob.obs_kf]  # [P,D,4,4]
    R = T[..., :3, :3]
    pc = torch.einsum("pdij,pj->pdi", R, points) + T[..., :3, 3]
    return _terms_at(pc, R, prob.obs, prob.is_stereo, cam)


def _terms_at(pc, R, obs, is_stereo, cam: Camera):
    """The edge terms of `_pm_edge_terms` (and of the COO `_edge_terms`)
    from the points in the camera frame pc [..., 3] and the rotations R
    [..., 3, 3] of the edges' cameras."""
    x, y, z = pc[..., 0], pc[..., 1], pc[..., 2]
    zs = torch.where(torch.abs(z) < 1e-6, 1e-6, z)
    inv_z = 1.0 / zs
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
    )
    hat_pc = se3.hat(pc)
    eye = torch.eye(3, dtype=pc.dtype, device=pc.device).expand(hat_pc.shape)
    dpc = torch.cat([-hat_pc, eye], dim=-1)
    Jc = -(dh @ dpc)
    Jp = -(dh @ R)
    comp = torch.stack([torch.ones_like(x), torch.ones_like(x), is_stereo.to(x.dtype)], -1)
    return r, Jc, Jp, comp, z > 0.0


def _pm_weights(r, comp, prob: BAProblemPM, depth_ok, use_huber: bool):
    """Per-edge IRLS weight w (Huber with the reference's deltas), chi2 e2
    and robust cost rho (0 for inactive edges)."""
    e2 = torch.sum(r * r * comp, dim=-1) * prob.inv_sigma2
    delta = torch.where(prob.is_stereo, DELTA_STEREO, DELTA_MONO)
    delta2 = delta * delta
    root = torch.sqrt(torch.clamp(e2, min=1e-12))
    huber = (e2 > delta2) if use_huber else torch.zeros_like(e2, dtype=torch.bool)
    w_h = torch.where(huber, delta / root, 1.0)
    active = prob.edge_valid & depth_ok
    w = torch.where(active, w_h * prob.inv_sigma2, 0.0)
    rho = torch.where(huber, 2.0 * delta * root - delta2, e2)
    return w, e2, torch.where(active, rho, 0.0)


class Segments(NamedTuple):
    """A fixed index [E] -> [0, K) laid out for fixed-order sums: `order`
    lists the kept entries grouped by index, in entry order within an
    index, and `offsets` [K + 1] bounds index k's group."""

    order: torch.Tensor
    offsets: torch.Tensor


def segments(idx: torch.Tensor, K: int, keep: torch.Tensor) -> Segments:
    """`idx`'s segments over the entries that `keep` marks, built once per
    problem: its index stays fixed for the whole solve. A stable sort and
    an integer count, so the layout is the same on every run; one host
    sync reads the number of kept entries."""
    key = torch.where(keep.reshape(-1), idx.reshape(-1), K)
    counts = torch.bincount(key, minlength=K + 1)[:K]
    offsets = F.pad(torch.cumsum(counts, 0), (1, 0))
    order = torch.argsort(key, stable=True)[:int(offsets[-1])]  # dropped entries (key K) last
    return Segments(order=order, offsets=offsets)


def segment_sum(seg: Segments, x: torch.Tensor) -> torch.Tensor:
    """x [E, ...] summed per index -> [K, ...], 0 for an empty segment.

    `torch.segment_reduce` over the entries gathered in segment order adds
    each segment's entries one after another, in entry order (the CPU's
    `index_add_` order), on every call and every run: on CUDA one thread
    computes each output element of a multi-dimensional input by a loop,
    and a one-dimensional input takes CUB's segmented reduction, whose
    tree is fixed, where a float `index_add_` adds in the order its
    atomics land. chip_smoke.py replays the solves on the card to check
    it."""
    return torch.segment_reduce(x[seg.order], "sum", offsets=seg.offsets, axis=0, unsafe=True)


def camera_segments(prob: BAProblemPM) -> Segments:
    """The segments of the camera index over the problem's valid [P, D]
    slots: a padded or invalid slot weighs nothing (its terms are exact
    zeros), and leaving it out keeps camera 0's segment from growing by
    every padding slot."""
    return segments(prob.obs_kf, prob.poses.shape[0], prob.edge_valid)


def _camera_sum(seg: Segments, x: torch.Tensor) -> torch.Tensor:
    """[P,D,c] per-edge values summed per camera -> [K, c] (fp32)."""
    return segment_sum(seg, x.reshape(-1, x.shape[-1]))


def psum(reducer, x: torch.Tensor) -> torch.Tensor:
    """x summed over the mesh's shards (x itself without a mesh)."""
    return x if reducer is None else reducer.sum(x)


def pmax(reducer, x: torch.Tensor) -> torch.Tensor:
    """The largest entry of x over the mesh's shards (a shard may hold no
    rows: its share is -inf)."""
    if reducer is None:
        return x.max()
    local = x.max() if x.numel() else torch.tensor(float("-inf"), dtype=x.dtype, device=x.device)
    return reducer.max(local)


def _pm_assemble(poses, points, prob: BAProblemPM, cam: Camera, use_huber: bool, seg: Segments,
                 reducer=None):
    """Gradients, diagonal blocks and robust cost (+ edge terms for reuse);
    the camera-side ones and the cost summed over the mesh's shards."""
    K = prob.poses.shape[0]
    r, Jc, Jp, comp, dok = _pm_edge_terms(poses, points, prob, cam)
    w, _, rho = _pm_weights(r, comp, prob, dok, use_huber)
    W = w[..., None] * comp  # [P,D,3]
    Wr = W * r
    gc = psum(reducer, _camera_sum(seg, torch.einsum("pdci,pdc->pdi", Jc, Wr)))
    gp = torch.einsum("pdci,pdc->pi", Jp, Wr)
    Hcc = psum(reducer, _camera_sum(seg, torch.einsum("pdci,pdc,pdcj->pdij", Jc, W, Jc).flatten(-2)))
    Hpp = torch.einsum("pdci,pdc,pdcj->pij", Jp, W, Jp)
    return (r, Jc, Jp, W), gc, gp, Hcc.reshape(K, 6, 6), Hpp, psum(reducer, torch.sum(rho))


def ba_pm_init(prob: BAProblemPM, cam: Camera, use_huber: bool = True,
               seg: Optional[Segments] = None, reducer=None) -> PMLMState:
    """Initial LM state: lambda = 1e-5 x the largest Hessian diagonal entry
    (g2o's heuristic). `seg`: `camera_segments(prob)`, built here if None."""
    seg = camera_segments(prob) if seg is None else seg
    _, _, _, Hcc0, Hpp0, F0 = _pm_assemble(prob.poses, prob.points, prob, cam, use_huber, seg, reducer)
    diag_max = torch.maximum(torch.diagonal(Hcc0, dim1=-2, dim2=-1).max(),
                             pmax(reducer, torch.diagonal(Hpp0, dim1=-2, dim2=-1)))
    return PMLMState(poses=prob.poses, points=prob.points, lam=1e-5 * diag_max,
                     ni=torch.full_like(F0, 2.0), F=F0)


def ba_pm_step(prob: BAProblemPM, cam: Camera, state: PMLMState, n_cg: int = 20,
               use_huber: bool = True, seg: Optional[Segments] = None, reducer=None) -> PMLMState:
    """One point-major LM iteration: PCG inner solve of the damped normal
    equations, then accept or reject on the device. `seg`:
    `camera_segments(prob)`, built here if None."""
    seg = camera_segments(prob) if seg is None else seg
    free = (~prob.pose_fixed).to(prob.poses.dtype)[:, None]
    poses, points, lam, ni, F = state
    (r, Jc, Jp, W), gc, gp, Hcc, Hpp, _ = _pm_assemble(poses, points, prob, cam, use_huber, seg, reducer)
    gc = gc * free
    eye6 = torch.eye(6, dtype=Hcc.dtype, device=Hcc.device)
    eye3 = torch.eye(3, dtype=Hpp.dtype, device=Hpp.device)
    Mc = torch.linalg.inv_ex(Hcc + (lam + 1e-6) * eye6).inverse
    Mp = inv3x3(Hpp + (lam + 1e-6) * eye3)

    def hv(vc, vp):
        vc = vc * free
        a = torch.einsum("pdci,pdi->pdc", Jc, vc[prob.obs_kf]) + torch.einsum("pdci,pi->pdc", Jp, vp)
        Wa = W * a
        Hc = psum(reducer, _camera_sum(seg, torch.einsum("pdci,pdc->pdi", Jc, Wa)))
        Hp = torch.einsum("pdci,pdc->pi", Jp, Wa)
        return (Hc + lam * vc) * free, Hp + lam * vp

    def precond(rc, rp):
        return (Mc @ rc[..., None])[..., 0] * free, (Mp @ rp[..., None])[..., 0]

    def dot(ac, bc, ap, bp):
        return torch.sum(ac * bc) + psum(reducer, torch.sum(ap * bp))

    def safe(x):
        return torch.where(torch.abs(x) < 1e-20, 1e-20, x)

    xc, xp = torch.zeros_like(gc), torch.zeros_like(gp)
    rc, rp = gc, gp
    zc, zp = precond(rc, rp)
    pc_, pp_ = zc, zp
    rz = dot(rc, zc, rp, zp)
    for _ in range(n_cg):
        Apc, App = hv(pc_, pp_)
        alpha = rz / safe(dot(pc_, Apc, pp_, App))
        xc = xc + alpha * pc_
        xp = xp + alpha * pp_
        rc = rc - alpha * Apc
        rp = rp - alpha * App
        zc, zp = precond(rc, rp)
        rz2 = dot(rc, zc, rp, zp)
        beta = rz2 / safe(rz)
        pc_, pp_, rz = zc + beta * pc_, zp + beta * pp_, rz2
    dxc = -xc * free
    dxp = -xp
    poses_new = se3.retract(poses, dxc)
    points_new = points + dxp
    F_new = _pm_assemble(poses_new, points_new, prob, cam, use_huber, seg, reducer)[-1]
    gdot = torch.sum(dxc * (lam * dxc - gc)) + psum(reducer, torch.sum(dxp * (lam * dxp - gp)))
    rho = (F - F_new) / (gdot + 1e-12)
    ok = (rho > 0) & torch.isfinite(F_new)
    return PMLMState(
        poses=torch.where(ok, poses_new, poses),
        points=torch.where(ok, points_new, points),
        lam=torch.where(ok, lam * torch.clamp(1 - (2 * rho - 1) ** 3, min=1 / 3), lam * ni),
        ni=torch.where(ok, 2.0, ni * 2.0),
        F=torch.where(ok, F_new, F),
    )


def pm_edge_chi2(poses, points, prob: BAProblemPM, cam: Camera):
    r, _, _, comp, dok = _pm_edge_terms(poses, points, prob, cam)
    return torch.sum(r * r * comp, dim=-1) * prob.inv_sigma2, dok


def pm_inlier_mask(poses, points, prob: BAProblemPM, cam: Camera) -> torch.Tensor:
    """Edges passing the chi2 gate (5.991 mono / 7.815 stereo) at the
    given estimate: the mid-schedule outlier cut and the final inliers."""
    e2, dok = pm_edge_chi2(poses, points, prob, cam)
    th = torch.where(prob.is_stereo, CHI2_STEREO, CHI2_MONO)
    return prob.edge_valid & (e2 <= th) & dok


def ba_solve_pm(prob: BAProblemPM, cam: Camera, n_iters_first: int = 5, n_iters_second: int = 10,
                n_cg: int = 20, reducer=None) -> BAResultPM:
    """The two-stage schedule; one host sync, in `camera_segments`.
    `reducer`: this shard's link to the other shards of a mesh
    (`parallel/mesh.py`), or None for the whole problem on one device."""
    seg = camera_segments(prob)
    state = ba_pm_init(prob, cam, seg=seg, reducer=reducer)
    for _ in range(n_iters_first):
        state = ba_pm_step(prob, cam, state, n_cg, seg=seg, reducer=reducer)
    prob2 = prob._replace(edge_valid=pm_inlier_mask(state.poses, state.points, prob, cam))
    state = ba_pm_init(prob2._replace(poses=state.poses, points=state.points), cam, seg=seg, reducer=reducer)
    for _ in range(n_iters_second):
        state = ba_pm_step(prob2, cam, state, n_cg, seg=seg, reducer=reducer)
    inlier = pm_inlier_mask(state.poses, state.points, prob2, cam)
    return BAResultPM(poses=state.poses, points=state.points, edge_inlier=inlier, final_chi2=state.F)


def ba_solve_pm_interruptible(
    prob: BAProblemPM,
    cam: Camera,
    should_abort: Optional[Callable[[], bool]] = None,
    n_iters_first: int = 5,
    n_iters_second: int = 10,
    n_cg: int = 20,
    sync_every: int = 3,
) -> BAResultPM:
    """The two-stage schedule with abort checks between chunks of LM
    iterations (reference mbAbortBA protocol, LocalMapping.cpp:109-114).

    `should_abort()` is polled before each chunk of at most `sync_every`
    iterations and before the second phase; once it returns True the
    remaining iterations are skipped and the current estimate is finalized
    (the chi2 inlier marking still runs). After each chunk the host reads
    `float(state.F)`, which bounds the abort latency."""
    if should_abort is None:
        should_abort = lambda: False  # noqa: E731
    seg = camera_segments(prob)

    def phase(prob_, state, n_iters):
        done = 0
        while done < n_iters:
            if should_abort():
                break
            n = min(sync_every, n_iters - done)
            for _ in range(n):
                state = ba_pm_step(prob_, cam, state, n_cg, seg=seg)
            float(state.F)
            done += n
        return state

    state = phase(prob, ba_pm_init(prob, cam, seg=seg), n_iters_first)
    prob2 = prob._replace(edge_valid=pm_inlier_mask(state.poses, state.points, prob, cam))
    if not should_abort():
        state = phase(prob2, ba_pm_init(prob2._replace(poses=state.poses, points=state.points), cam, seg=seg),
                      n_iters_second)
    inlier = pm_inlier_mask(state.poses, state.points, prob2, cam)
    return BAResultPM(poses=state.poses, points=state.points, edge_inlier=inlier, final_chi2=state.F)


# ---------------------------------------------------------------------------
# Edge-major (COO) bundle adjustment
#
# Port of orbslam2_tpu/ops/ba.py's first solver (:41-338): one row per
# observation (camera, point) and no layout to build, the JAX package's
# reference and fallback; no SLAM module calls it. Every per-camera and
# per-point sum is a fixed-order `segment_sum` (never a float `index_add_`,
# whose atomics on the card add in the order they land), fp32 as in the JAX
# package. With a `reducer` (one shard of a mesh, `parallel/dist_ba.py`)
# the problem holds this shard's edges, poses and points are replicated,
# and the per-camera and per-point sums and the cost are summed over the
# shards, where the JAX package psums over its mesh axis.
# ---------------------------------------------------------------------------


class BAProblem(NamedTuple):
    poses: torch.Tensor  # [K,4,4] float32 Tcw
    points: torch.Tensor  # [P,3] float32
    obs_kf: torch.Tensor  # [E] int64 camera index per edge
    obs_pt: torch.Tensor  # [E] int64 point index per edge
    obs: torch.Tensor  # [E,3] (u, v, uR)
    inv_sigma2: torch.Tensor  # [E]
    is_stereo: torch.Tensor  # [E] bool
    edge_valid: torch.Tensor  # [E] bool
    pose_fixed: torch.Tensor  # [K] bool


class BAResult(NamedTuple):
    poses: torch.Tensor
    points: torch.Tensor
    edge_inlier: torch.Tensor  # [E] bool (valid and passed the final chi2)
    final_chi2: torch.Tensor


class EdgeSegments(NamedTuple):
    """The segments of the edges' camera and point indices over the valid
    edges, built once per solve (a padded or invalid edge weighs nothing)."""

    cam: Segments
    pt: Segments


def edge_segments(prob: BAProblem) -> EdgeSegments:
    return EdgeSegments(cam=segments(prob.obs_kf, prob.poses.shape[0], prob.edge_valid),
                        pt=segments(prob.obs_pt, prob.points.shape[0], prob.edge_valid))


def _edge_terms(poses, points, prob: BAProblem, cam: Camera):
    """Residual r [E,3], Jc [E,3,6], Jp [E,3,3], component mask [E,3] and
    z > 0 [E] of every edge (JAX `_edge_terms`)."""
    T = poses[prob.obs_kf]  # [E,4,4]
    R = T[..., :3, :3]
    pc = torch.einsum("eij,ej->ei", R, points[prob.obs_pt]) + T[..., :3, 3]
    return _terms_at(pc, R, prob.obs, prob.is_stereo, cam)


def _assemble(poses, points, prob: BAProblem, cam: Camera, use_huber: bool, seg: EdgeSegments, reducer=None):
    """(edge terms for reuse, gradients gc [K,6] and gp [P,3], diagonal
    blocks Hcc [K,6,6] and Hpp [P,3,3], robust cost), every sum over the
    mesh's shards. The cost adds the valid edges in the camera segments'
    order, so padding edges changes none of its bits."""
    K, P = prob.poses.shape[0], prob.points.shape[0]
    r, Jc, Jp, comp, dok = _edge_terms(poses, points, prob, cam)
    w, _, rho = _pm_weights(r, comp, prob, dok, use_huber)
    W = w[:, None] * comp  # [E,3]
    Wr = W * r
    gc = psum(reducer, segment_sum(seg.cam, torch.einsum("eci,ec->ei", Jc, Wr)))
    gp = psum(reducer, segment_sum(seg.pt, torch.einsum("eci,ec->ei", Jp, Wr)))
    Hcc = psum(reducer, segment_sum(seg.cam, torch.einsum("eci,ec,ecj->eij", Jc, W, Jc).flatten(-2)))
    Hpp = psum(reducer, segment_sum(seg.pt, torch.einsum("eci,ec,ecj->eij", Jp, W, Jp).flatten(-2)))
    F_ = psum(reducer, torch.sum(rho[seg.cam.order]))
    return (Jc, Jp, W), gc, gp, Hcc.reshape(K, 6, 6), Hpp.reshape(P, 3, 3), F_


def _pcg_solve(prob: BAProblem, terms, gc, gp, Hcc, Hpp, lam, n_cg: int, seg: EdgeSegments, reducer=None):
    """Solve (H + lam I) dx = -g by block-Jacobi PCG, H applied matrix-free
    over the edges; returns (dxc, dxp, gc with the fixed poses' rows 0)."""
    Jc, Jp, W = terms
    free = (~prob.pose_fixed).to(gc.dtype)[:, None]
    gc = gc * free
    eye6 = torch.eye(6, dtype=Hcc.dtype, device=Hcc.device)
    eye3 = torch.eye(3, dtype=Hpp.dtype, device=Hpp.device)
    Mc = torch.linalg.inv_ex(Hcc + (lam + 1e-6) * eye6).inverse
    Mp = inv3x3(Hpp + (lam + 1e-6) * eye3)

    def hv(vc, vp):
        vc = vc * free
        a = torch.einsum("eci,ei->ec", Jc, vc[prob.obs_kf]) + torch.einsum("eci,ei->ec", Jp, vp[prob.obs_pt])
        Wa = W * a
        Hc = psum(reducer, segment_sum(seg.cam, torch.einsum("eci,ec->ei", Jc, Wa))) + lam * vc
        Hp = psum(reducer, segment_sum(seg.pt, torch.einsum("eci,ec->ei", Jp, Wa))) + lam * vp
        return Hc * free, Hp

    def precond(rc, rp):
        return (Mc @ rc[..., None])[..., 0] * free, (Mp @ rp[..., None])[..., 0]

    def safe(x):
        return torch.where(torch.abs(x) < 1e-20, 1e-20, x)

    xc, xp = torch.zeros_like(gc), torch.zeros_like(gp)
    rc, rp = gc, gp
    zc, zp = precond(rc, rp)
    pc_, pp_ = zc, zp
    rz = torch.sum(rc * zc) + torch.sum(rp * zp)
    for _ in range(n_cg):
        Apc, App = hv(pc_, pp_)
        alpha = rz / safe(torch.sum(pc_ * Apc) + torch.sum(pp_ * App))
        xc = xc + alpha * pc_
        xp = xp + alpha * pp_
        rc = rc - alpha * Apc
        rp = rp - alpha * App
        zc, zp = precond(rc, rp)
        rz2 = torch.sum(rc * zc) + torch.sum(rp * zp)
        beta = rz2 / safe(rz)
        pc_, pp_, rz = zc + beta * pc_, zp + beta * pp_, rz2
    return -xc, -xp, gc


def _lm_run(prob: BAProblem, cam: Camera, poses, points, n_iters: int, n_cg: int, seg: EdgeSegments,
            reducer=None, use_huber: bool = True):
    """n_iters LM iterations from (poses, points), lambda from g2o's
    heuristic; accept or reject on the device. Returns (poses, points, F)."""
    terms, gc, gp, Hcc, Hpp, F_ = _assemble(poses, points, prob, cam, use_huber, seg, reducer)
    lam = 1e-5 * torch.maximum(torch.diagonal(Hcc, dim1=-2, dim2=-1).max(),
                               torch.diagonal(Hpp, dim1=-2, dim2=-1).max())
    ni = torch.full_like(F_, 2.0)
    free = (~prob.pose_fixed).to(poses.dtype)[:, None]
    for it in range(n_iters):
        if it:
            terms, gc, gp, Hcc, Hpp, _ = _assemble(poses, points, prob, cam, use_huber, seg, reducer)
        dxc, dxp, gc = _pcg_solve(prob, terms, gc, gp, Hcc, Hpp, lam, n_cg, seg, reducer)
        dxc = dxc * free
        poses_new = se3.retract(poses, dxc)
        points_new = points + dxp
        F_new = _assemble(poses_new, points_new, prob, cam, use_huber, seg, reducer)[-1]
        gdot = torch.sum(dxc * (lam * dxc - gc)) + torch.sum(dxp * (lam * dxp - gp))
        rho = (F_ - F_new) / (gdot + 1e-12)
        ok = (rho > 0) & torch.isfinite(F_new)
        poses = torch.where(ok, poses_new, poses)
        points = torch.where(ok, points_new, points)
        F_ = torch.where(ok, F_new, F_)
        lam = torch.where(ok, lam * torch.clamp(1 - (2 * rho - 1) ** 3, min=1 / 3), lam * ni)
        ni = torch.where(ok, 2.0, ni * 2.0)
    return poses, points, F_


def edge_chi2(poses, points, prob: BAProblem, cam: Camera):
    """(chi2 [E], z > 0 [E]) of every edge at the given estimate."""
    r, _, _, comp, dok = _edge_terms(poses, points, prob, cam)
    return torch.sum(r * r * comp, dim=-1) * prob.inv_sigma2, dok


def ba_solve(prob: BAProblem, cam: Camera, n_iters_first: int = 5, n_iters_second: int = 10, n_cg: int = 30,
             reducer=None) -> BAResult:
    """The reference's two-stage schedule on the COO problem: 5 LM
    iterations, the chi2 cut (5.991 mono / 7.815 stereo) and depth, 10 more,
    then the final inliers. Two host syncs, in `edge_segments`. `reducer`:
    this shard's link to the other shards of a mesh (`parallel/dist_ba.py::
    make_distributed_ba`), or None for the whole problem on one device."""
    seg = edge_segments(prob)
    poses, points, _ = _lm_run(prob, cam, prob.poses, prob.points, n_iters_first, n_cg, seg, reducer)
    e2, dok = edge_chi2(poses, points, prob, cam)
    th = torch.where(prob.is_stereo, CHI2_STEREO, CHI2_MONO)
    keep = prob.edge_valid & (e2 <= th) & dok
    prob2 = prob._replace(edge_valid=keep)
    poses, points, F_ = _lm_run(prob2, cam, poses, points, n_iters_second, n_cg, seg, reducer)
    e2, dok = edge_chi2(poses, points, prob2, cam)
    return BAResult(poses=poses, points=points, edge_inlier=keep & (e2 <= th) & dok, final_chi2=F_)


def coo_to_pm(prob: BAProblem, max_obs: int = 16) -> BAProblemPM:
    """The point-major layout of a COO problem (JAX `coo_to_pm`, on the
    host): each point's valid edges in edge order, at most `max_obs` of
    them (later ones dropped), the rows padded to the next power of two of
    the largest count. The result's tensors lie on the problem's device."""
    obs_pt = prob.obs_pt.cpu().numpy()
    order = np.argsort(obs_pt, kind="stable")
    edges = order[prob.edge_valid.cpu().numpy()[order]]
    pt = obs_pt[edges]
    first = np.searchsorted(pt, pt, side="left")
    slot = np.arange(len(edges)) - first
    kept = slot < max_obs
    edges, pt, slot = edges[kept], pt[kept], slot[kept]
    D = int(slot.max()) + 1 if slot.size else 1
    D = min(1 << (D - 1).bit_length(), max_obs)
    P, dev = prob.points.shape[0], prob.points.device

    def rows(values, fill, dtype):
        out = torch.full((P, D) + tuple(values.shape[1:]), fill, dtype=dtype)
        out[torch.from_numpy(pt), torch.from_numpy(slot)] = values.cpu()[torch.from_numpy(edges)].to(dtype)
        return out.to(dev)

    return BAProblemPM(
        poses=prob.poses, points=prob.points,
        obs_kf=rows(prob.obs_kf, 0, torch.int64), obs=rows(prob.obs, 0.0, torch.float32),
        inv_sigma2=rows(prob.inv_sigma2, 1.0, torch.float32), is_stereo=rows(prob.is_stereo, False, torch.bool),
        edge_valid=rows(torch.ones_like(prob.edge_valid), False, torch.bool), pose_fixed=prob.pose_fixed,
    )
