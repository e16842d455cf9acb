"""Bundle adjustment over a device mesh.

Port of orbslam2_tpu/parallel/dist_ba.py. `make_distributed_ba_pm` is the
north star's "keyframe/map-block partitioned global BA": each shard owns a
block of point rows (its share of the map) and their observations, the
poses are replicated, and the camera-side normal equations, the cost and
the point halves of the PCG's dot products are summed over the shards
(`ops/ba.py`'s `reducer`). Every shard computes the same camera update
from the same sums, so the poses stay replicated.

`make_distributed_ba` shards the edge-major (COO) solver `ops/ba.py::
ba_solve` by its edges: poses and points are replicated, and every per-camera
and per-point sum and the cost are summed over the shards, so every shard
computes the same update. Its cross-shard sums go through the same
reducers, in shard order on one process and by `all_reduce` over a process
group.

Eager PyTorch needs no equal shard sizes (`mesh.put_global` cuts with
`torch.tensor_split`); `pad_edges_to_multiple` and `pad_points_to_multiple`
pad a problem with invalid rows to a multiple of the mesh size, as the JAX
package must, and a padded problem solves to the unpadded one's result.
"""

from __future__ import annotations

import torch

from ..geometry.camera import Camera
from ..ops import ba
from .mesh import REPLICATED, SHARDED, Mesh, ShardedTree, gather_rows, put_global

#: point rows and their observations sharded, poses replicated
PM_SPECS = ba.BAProblemPM(
    poses=REPLICATED, points=SHARDED, obs_kf=SHARDED, obs=SHARDED, inv_sigma2=SHARDED,
    is_stereo=SHARDED, edge_valid=SHARDED, pose_fixed=REPLICATED,
)
#: edges sharded, poses and points replicated
COO_SPECS = ba.BAProblem(
    poses=REPLICATED, points=REPLICATED, obs_kf=SHARDED, obs_pt=SHARDED, obs=SHARDED, inv_sigma2=SHARDED,
    is_stereo=SHARDED, edge_valid=SHARDED, pose_fixed=REPLICATED,
)


def _pad_rows(x: torch.Tensor, pad: int) -> torch.Tensor:
    """x with `pad` rows of zeros (False) appended along its first axis."""
    return torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])


def pad_edges_to_multiple(prob: ba.BAProblem, n: int) -> ba.BAProblem:
    """The COO problem with its edges padded to a multiple of n (the padded
    edges invalid, on point and camera 0)."""
    pad = (-prob.obs.shape[0]) % n
    if pad == 0:
        return prob
    return prob._replace(**{f: _pad_rows(getattr(prob, f), pad) for f in (
        "obs_kf", "obs_pt", "obs", "inv_sigma2", "is_stereo", "edge_valid")})


def pad_points_to_multiple(prob: ba.BAProblemPM, n: int) -> ba.BAProblemPM:
    """The point-major problem with its point rows padded to a multiple of
    n (the padded rows' observations invalid)."""
    pad = (-prob.points.shape[0]) % n
    if pad == 0:
        return prob
    return prob._replace(**{f: _pad_rows(getattr(prob, f), pad) for f in (
        "points", "obs_kf", "obs", "inv_sigma2", "is_stereo", "edge_valid")})


def make_distributed_ba(mesh: Mesh, cam: Camera, n_iters_first: int = 5, n_iters_second: int = 10,
                        n_cg: int = 30):
    """fn(prob) -> BAResult: the two-stage schedule of `ba.ba_solve` on
    every shard of `mesh`, the edges sharded. `prob` is a whole `BAProblem`
    (tensors or numpy arrays, alike on every process) or what
    `put_global(prob, COO_SPECS, mesh)` made of one. The result's poses,
    points and cost come from shard 0; its inlier mask is joined in edge
    order (`mesh.gather_rows`)."""

    def body(shard: ba.BAProblem, reducer) -> ba.BAResult:
        shard = shard._replace(obs_kf=shard.obs_kf.long(), obs_pt=shard.obs_pt.long())
        return ba.ba_solve(shard, cam, n_iters_first=n_iters_first, n_iters_second=n_iters_second, n_cg=n_cg,
                           reducer=reducer)

    def solve(prob) -> ba.BAResult:
        shards = prob if isinstance(prob, ShardedTree) else put_global(prob, COO_SPECS, mesh)
        outs = mesh.run(body, shards)
        return ba.BAResult(poses=outs[0].poses, points=outs[0].points,
                           edge_inlier=gather_rows([o.edge_inlier for o in outs], mesh),
                           final_chi2=outs[0].final_chi2)

    return solve


def make_distributed_ba_pm(mesh: Mesh, cam: Camera, n_iters_first: int = 5, n_iters_second: int = 10,
                           n_cg: int = 20):
    """fn(prob) -> BAResultPM: the two-stage schedule of `ba.ba_solve_pm` on
    every shard of `mesh`. `prob` is a whole `BAProblemPM` (tensors or
    numpy arrays, alike on every process) or what `put_global(prob,
    PM_SPECS, mesh)` made of one. The result's poses and cost come from
    shard 0; its points and inlier mask are joined in row order
    (`mesh.gather_rows`)."""

    def body(shard: ba.BAProblemPM, reducer) -> ba.BAResultPM:
        shard = shard._replace(obs_kf=shard.obs_kf.long())
        return ba.ba_solve_pm(shard, cam, n_iters_first=n_iters_first, n_iters_second=n_iters_second,
                              n_cg=n_cg, reducer=reducer)

    def solve(prob) -> ba.BAResultPM:
        shards = prob if isinstance(prob, ShardedTree) else put_global(prob, PM_SPECS, mesh)
        outs = mesh.run(body, shards)
        return ba.BAResultPM(
            poses=outs[0].poses,
            points=gather_rows([o.points for o in outs], mesh),
            edge_inlier=gather_rows([o.edge_inlier for o in outs], mesh),
            final_chi2=outs[0].final_chi2,
        )

    return solve
