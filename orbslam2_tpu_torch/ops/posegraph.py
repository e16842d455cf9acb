"""Essential-graph optimization: LM over Sim3 vertices with a PCG solve.

Port of orbslam2_tpu/ops/posegraph.py (reference Optimizer::
OptimizeEssentialGraph, src/Optimizer.cpp:790-1052: g2o LM over
VertexSim3Expmap with EdgeSim3, lambda init 1e-16, 20 iterations,
identity information):

  * vertices: every keyframe as a Sim3 (R [K, 3, 3], t [K, 3], s [K]);
  * edges: loop connections, spanning tree, covisibility >= 100 and past
    loop edges, each with its measurement Sji;
  * residual per edge r = log(Sji o Si o Sj^-1) [7]; its Jacobians with
    respect to left retractions of Si and Sj by forward-mode AD, one
    batched dual pass for every edge and direction (the JAX package
    vmaps jax.jacfwd over the edges);
  * the normal equations solved matrix-free by block-Jacobi PCG, the
    gradient, the diagonal blocks and each H*p product summed per vertex
    over both ends of every edge by one fixed-order segment sum
    (`ops/ba.py::segment_sum`), so a solve gives the same bits on every
    run on the card.

Fixed vertices and, with `fix_scale` (stereo, Optimizer.cpp:848), the
log-scale coordinate take no update. The solve runs in the problem's
dtype: the loop closer builds it in float64 (the JAX package solves in
float32), so that the card and the CPU agree to far below the test's bar.
One host sync, when the per-vertex segments are built. With a `reducer`
(one shard of a mesh, `parallel/dist_posegraph.py`) the problem holds this
shard's edges and every per-vertex sum (gradient, diagonal blocks, each
H*p product) and the cost go through `reducer.sum`, where the JAX package
psums over its mesh axis; without one the solve is what it was before
meshes were ported, bit for bit.
"""

from __future__ import annotations

import threading
from typing import NamedTuple

import torch
import torch.autograd.forward_ad as fwAD

from ..geometry import sim3
from .ba import psum, segment_sum, segments

#: forward-mode AD has one dual level per process, so the shards of an
#: in-process mesh (one thread each) take turns at it
_DUAL_LEVEL = threading.Lock()


class PoseGraphProblem(NamedTuple):
    vertices: sim3.Sim3  # batched [K]
    edge_i: torch.Tensor  # [E] int64
    edge_j: torch.Tensor  # [E] int64
    meas: sim3.Sim3  # batched [E]: the Sji measurements
    edge_valid: torch.Tensor  # [E] bool
    fixed: torch.Tensor  # [K] bool


def _edge_residual(Si: sim3.Sim3, Sj: sim3.Sim3, Sji: sim3.Sim3) -> torch.Tensor:
    return sim3.log(sim3.compose(Sji, sim3.compose(Si, sim3.inverse(Sj))))


def _edge_res_jac(Si: sim3.Sim3, Sj: sim3.Sim3, Sji: sim3.Sim3):
    """Residuals [E, 7] and Jacobians [E, 7, 7] with respect to the left
    retractions of Si and Sj, at zero, by forward-mode AD (what the JAX
    package's jax.jacfwd computes): one dual pass over a batch of 14
    copies of the edges, copy k carrying the tangent of coordinate k of
    (xi_i, xi_j). Edge e's residual depends only on its own tangents, so
    copy k's output tangent is column k of each edge's Jacobian."""
    E = Sji.s.shape[0]
    dtype, dev = Sji.t.dtype, Sji.t.device
    tangents = torch.eye(14, dtype=dtype, device=dev)[:, None, :].expand(14, E, 14)
    with _DUAL_LEVEL, fwAD.dual_level():
        x = fwAD.make_dual(torch.zeros(14, E, 14, dtype=dtype, device=dev), tangents)
        r = _edge_residual(sim3.retract(Si, x[..., :7]), sim3.retract(Sj, x[..., 7:]), Sji)
        r, dr = fwAD.unpack_dual(r)
    J = dr.permute(1, 2, 0)  # [E, 7, 14]
    return r[0], J[..., :7], J[..., 7:]


def _gather(S: sim3.Sim3, idx) -> sim3.Sim3:
    return sim3.Sim3(R=S.R[idx], t=S.t[idx], s=S.s[idx])


def optimize_essential_graph(prob: PoseGraphProblem, n_iters: int = 20, n_cg: int = 50,
                             fix_scale: bool = True, reducer=None):
    """Returns (optimized vertices as a batched Sim3, final cost).
    `reducer`: this shard's link to the other shards of a mesh
    (`parallel/mesh.py`), or None for the whole graph on one device."""
    K = prob.vertices.s.shape[0]
    V0 = prob.vertices
    dtype, dev = V0.t.dtype, V0.t.device
    ei, ej = prob.edge_i.long(), prob.edge_j.long()
    w = prob.edge_valid.to(dtype)
    update = (~prob.fixed).to(dtype)[:, None].expand(K, 7).clone()
    if fix_scale:
        update[:, 6] = 0.0
    eye7 = torch.eye(7, dtype=dtype, device=dev)
    # the edges' two ends as one fixed index: entry e is edge e's i end,
    # entry E + e its j end; an invalid edge weighs nothing and stays out
    ends = segments(torch.cat([ei, ej]), K, torch.cat([prob.edge_valid, prob.edge_valid]))

    def vsum(xi, xj):
        return psum(reducer, segment_sum(ends, torch.cat([xi, xj])))

    def cost(V):
        r = _edge_residual(_gather(V, ei), _gather(V, ej), prob.meas)
        return psum(reducer, ((r * r) * w[:, None]).sum())

    def assemble(V):
        r, Ji, Jj = _edge_res_jac(_gather(V, ei), _gather(V, ej), prob.meas)
        rw = r * w[:, None]
        g = vsum(torch.einsum("eci,ec->ei", Ji, rw), torch.einsum("eci,ec->ei", Jj, rw))
        Hd = vsum(torch.einsum("eci,e,ecj->eij", Ji, w, Ji), torch.einsum("eci,e,ecj->eij", Jj, w, Jj))
        return g, Hd, Ji, Jj

    def hv(v, Ji, Jj, lam):
        a = torch.einsum("eci,ei->ec", Ji, v[ei]) + torch.einsum("eci,ei->ec", Jj, v[ej])
        aw = a * w[:, None]
        return vsum(torch.einsum("eci,ec->ei", Ji, aw), torch.einsum("eci,ec->ei", Jj, aw)) + lam * v

    def safe(x):
        return torch.where(torch.abs(x) < 1e-20, 1e-20, x)

    V = V0
    lam = torch.tensor(1e-16, dtype=dtype, device=dev)  # g2o's lambda init (Optimizer.cpp:812)
    ni = torch.tensor(2.0, dtype=dtype, device=dev)
    F = cost(V)
    for _ in range(n_iters):
        g, Hd, Ji, Jj = assemble(V)
        g = g * update
        M = torch.linalg.inv_ex(Hd + (lam + 1e-8) * eye7)[0]

        def precond(r_):
            return torch.einsum("kij,kj->ki", M, r_) * update

        x = torch.zeros((K, 7), dtype=dtype, device=dev)
        r_ = g
        z = precond(r_)
        p = z
        rz = (r_ * z).sum()
        for _ in range(n_cg):
            Ap = hv(p * update, Ji, Jj, lam) * update
            alpha = rz / safe((p * Ap).sum())
            x = x + alpha * p
            r_ = r_ - alpha * Ap
            z = precond(r_)
            rz_new = (r_ * z).sum()
            p = z + (rz_new / safe(rz)) * p
            rz = rz_new
        dx = -x * update
        V_new = sim3.retract(V, dx)
        F_new = cost(V_new)
        rho = (F - F_new) / ((dx * (lam * dx - g)).sum() + 1e-12)
        ok = (rho > 0) & torch.isfinite(F_new)
        V = sim3.Sim3(*(torch.where(ok, a, b) for a, b in zip(V_new, V)))
        F = torch.where(ok, F_new, F)
        lam = torch.where(ok, lam * torch.clamp(1 - (2 * rho - 1) ** 3, min=1 / 3), lam * ni)
        ni = torch.where(ok, 2.0, ni * 2.0)
    return V, F
