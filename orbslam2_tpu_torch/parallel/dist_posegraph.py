"""The essential graph (Sim3 pose graph) over a device mesh.

Port of orbslam2_tpu/parallel/dist_posegraph.py::make_distributed_posegraph:
the Sim3 edges (spanning tree, covisibility >= 100, loop edges) are
sharded over the mesh and the vertices replicated; the gradient, the
block-diagonal preconditioner, each H*p product of the PCG and the cost
are summed over the shards (`ops/posegraph.py`'s `reducer`). It solves in
the problem's dtype (float64 from the loop closer), with a fixed or a free
scale (`fix_scale`: the stereo and the monocular loop).

Eager PyTorch needs no equal shard sizes (`mesh.put_global` cuts the
edges with `torch.tensor_split`); `pad_graph_edges_to_multiple` pads a
graph with invalid identity edges to a multiple of the mesh size, as the
JAX package must, and a padded graph solves to the unpadded one's result.
"""

from __future__ import annotations

import torch

from ..geometry import sim3
from ..ops import posegraph
from .mesh import REPLICATED, SHARDED, Mesh, ShardedTree, put_global

#: edges sharded, vertices replicated
PG_SPECS = posegraph.PoseGraphProblem(
    vertices=REPLICATED, edge_i=SHARDED, edge_j=SHARDED, meas=sim3.Sim3(SHARDED, SHARDED, SHARDED),
    edge_valid=SHARDED, fixed=REPLICATED,
)


def pad_graph_edges_to_multiple(prob: posegraph.PoseGraphProblem, n: int) -> posegraph.PoseGraphProblem:
    """The graph with its edges padded to a multiple of n: invalid edges
    from vertex 0 to 0 with identity measurements (finite terms)."""
    pad = (-prob.edge_i.shape[0]) % n
    if pad == 0:
        return prob
    m = prob.meas
    eye = sim3.Sim3(R=torch.eye(3, dtype=m.R.dtype, device=m.R.device).expand(pad, 3, 3),
                    t=m.t.new_zeros((pad, 3)), s=m.s.new_ones((pad,)))
    return prob._replace(
        edge_i=torch.cat([prob.edge_i, prob.edge_i.new_zeros(pad)]),
        edge_j=torch.cat([prob.edge_j, prob.edge_j.new_zeros(pad)]),
        meas=sim3.Sim3(*(torch.cat([a, b]) for a, b in zip(m, eye))),
        edge_valid=torch.cat([prob.edge_valid, prob.edge_valid.new_zeros(pad)]),
    )


def make_distributed_posegraph(mesh: Mesh, n_iters: int = 20, n_cg: int = 50, fix_scale: bool = True):
    """fn(prob) -> (vertices as a batched Sim3, final cost), from shard 0:
    `posegraph.optimize_essential_graph` on every shard of `mesh`. `prob` is
    a whole `PoseGraphProblem` or what `put_global(prob, PG_SPECS, mesh)`
    made of one."""

    def body(shard: posegraph.PoseGraphProblem, reducer):
        return posegraph.optimize_essential_graph(shard, n_iters=n_iters, n_cg=n_cg, fix_scale=fix_scale,
                                                  reducer=reducer)

    def solve(prob):
        shards = prob if isinstance(prob, ShardedTree) else put_global(prob, PG_SPECS, mesh)
        return mesh.run(body, shards)[0]

    return solve
