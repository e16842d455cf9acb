"""The point-major bundle adjustment over a device mesh.

Port of orbslam2_tpu/parallel/dist_ba.py::make_distributed_ba_pm, the
north star's "keyframe/map-block partitioned global BA": each shard owns a
block of point rows (its share of the map) and their observations, the
poses are replicated, and the camera-side normal equations, the cost and
the point halves of the PCG's dot products are summed over the shards
(`ops/ba.py`'s `reducer`). Every shard computes the same camera update
from the same sums, so the poses stay replicated.

Not ported: `pad_points_to_multiple`, since eager PyTorch needs no equal
shard sizes (`mesh.put_global` cuts the rows with `torch.tensor_split`);
and the COO solver `make_distributed_ba` / `pad_edges_to_multiple`, which
no SLAM module calls (ROADMAP "Do not port").
"""

from __future__ import annotations

from ..geometry.camera import Camera
from ..ops import ba
from .mesh import REPLICATED, SHARDED, Mesh, ShardedTree, gather_rows, put_global

#: point rows and their observations sharded, poses replicated
PM_SPECS = ba.BAProblemPM(
    poses=REPLICATED, points=SHARDED, obs_kf=SHARDED, obs=SHARDED, inv_sigma2=SHARDED,
    is_stereo=SHARDED, edge_valid=SHARDED, pose_fixed=REPLICATED,
)


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
