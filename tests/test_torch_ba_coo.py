"""The PyTorch port's edge-major (COO) bundle adjustment against the JAX
package's, on tests/test_ba.py's bundle (K = 6 cameras, P = 250 points,
stereo edges with 0.3 px noise; with and without 10% outliers).

Stated bars:
  * `coo_to_pm` equal to the JAX package's, array for array;
  * `ba_solve` against `ba_solve_jit`: final chi2 within 1e-4 relative,
    poses within 1e-5, every point within 1e-3 and the same inlier edges.
    Both solve in float32; the port's per-camera and per-point sums are
    fixed-order segment sums where XLA scatters, so the last bits of each
    sum differ and the PCG carries the gap (measured: chi2 5e-6 relative,
    poses 7e-7, points 7e-5);
  * `make_distributed_ba` on 2 CPU shards against one device: the
    cross-shard sums add two partial sums where one device adds once, so
    poses within 1e-5, points within 1e-3, chi2 within 1e-5 relative, the
    same inlier edges;
  * padding: a COO problem padded with invalid edges, and a pose graph
    padded with invalid edges, solve to the unpadded result bit for bit
    (padded edges are left out of every sum); a point-major problem padded
    with invalid rows within the bars of the sharded solve, poses 1e-5 and
    points 1e-3, with the same inlier edges (its point-side dot products
    sum longer vectors, in other blocks: measured points 6e-5 at 27 m).

The inputs are made with numpy from a seed (0).
"""

import functools

import jax
import numpy as np
import pytest
import torch
from test_ba import make_bundle
from test_dist_ba import _drift_chain_graph

from orbslam2_tpu.ops import ba as jba
from orbslam2_tpu_torch import convert
from orbslam2_tpu_torch.geometry import camera as tcamera
from orbslam2_tpu_torch.ops import ba as tba
from orbslam2_tpu_torch.ops import posegraph
from orbslam2_tpu_torch.parallel import dist_ba, dist_posegraph, mesh

# six xdist workers share the machine: one intra-op thread each
torch.set_num_threads(1)


@functools.lru_cache(maxsize=None)
def _bundle(outlier_frac):
    """(JAX camera, JAX problem, the port's camera, the port's problem, the
    outlier edges), made once per fraction (the tests replace fields, never
    mutate)."""
    jcam, prob, _, _, out_idx = make_bundle(np.random.default_rng(0), K=6, P=250, noise_px=0.3,
                                            outlier_frac=outlier_frac)
    tcam = tcamera.make_camera(jcam.fx, jcam.fy, jcam.cx, jcam.cy, bf=jcam.bf, width=jcam.width,
                               height=jcam.height)
    return jcam, prob, tcam, convert.ba_problem_to_torch(jax.device_get(prob), "cpu"), out_idx


def test_coo_to_pm_equals_jax():
    _, prob, _, tp, _ = _bundle(0.1)
    # some invalid edges, and a cap below the largest count, drop edges
    keep = np.random.default_rng(1).uniform(size=tp.edge_valid.shape[0]) > 0.2
    prob = prob._replace(edge_valid=prob.edge_valid & keep)
    tp = tp._replace(edge_valid=tp.edge_valid & torch.from_numpy(keep))
    for max_obs in (16, 4):
        want = jax.device_get(jba.coo_to_pm(prob, max_obs))
        got = tba.coo_to_pm(tp, max_obs)
        for name in want._fields:
            np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)), name)


@pytest.mark.parametrize("outlier_frac", [0.0, 0.1])
def test_ba_solve_matches_jax(outlier_frac):
    jcam, prob, tcam, tp, out_idx = _bundle(outlier_frac)
    want = jax.device_get(jba.ba_solve_jit(prob, jcam))
    got = tba.ba_solve(tp, tcam)
    assert abs(float(got.final_chi2) - float(want.final_chi2)) < 1e-4 * float(want.final_chi2)
    np.testing.assert_allclose(got.poses.numpy(), want.poses, atol=1e-5)
    np.testing.assert_allclose(got.points.numpy(), want.points, atol=1e-3)
    np.testing.assert_array_equal(got.edge_inlier.numpy(), want.edge_inlier)
    if outlier_frac:
        assert got.edge_inlier.numpy()[out_idx].mean() < 0.05


def test_sharded_and_padded_solves():
    _, _, tcam, tp, _ = _bundle(0.1)
    one = tba.ba_solve(tp, tcam)
    two = dist_ba.make_distributed_ba(mesh.make_mesh(2, device="cpu"), tcam)(tp)
    np.testing.assert_allclose(two.poses.numpy(), one.poses.numpy(), atol=1e-5)
    np.testing.assert_allclose(two.points.numpy(), one.points.numpy(), atol=1e-3)
    assert abs(float(two.final_chi2) - float(one.final_chi2)) < 1e-5 * float(one.final_chi2)
    assert torch.equal(two.edge_inlier, one.edge_inlier)

    E = tp.obs.shape[0]
    padded = tba.ba_solve(dist_ba.pad_edges_to_multiple(tp, 8), tcam)
    assert padded.edge_inlier.shape[0] % 8 == 0 and padded.edge_inlier.shape[0] > E
    for a, b in ((padded.poses, one.poses), (padded.points, one.points), (padded.final_chi2, one.final_chi2),
                 (padded.edge_inlier[:E], one.edge_inlier)):
        assert torch.equal(a, b)
    assert not padded.edge_inlier[E:].any()

    pm = tba.coo_to_pm(tp)
    P = pm.points.shape[0]
    pm_one = tba.ba_solve_pm(pm, tcam)
    pm_pad = tba.ba_solve_pm(dist_ba.pad_points_to_multiple(pm, 8), tcam)
    assert pm_pad.points.shape[0] % 8 == 0 and pm_pad.points.shape[0] > P
    np.testing.assert_allclose(pm_pad.poses.numpy(), pm_one.poses.numpy(), atol=1e-5)
    np.testing.assert_allclose(pm_pad.points[:P].numpy(), pm_one.points.numpy(), atol=1e-3)
    assert torch.equal(pm_pad.edge_inlier[:P], pm_one.edge_inlier) and not pm_pad.edge_inlier[P:].any()

    graph = convert.pose_graph_to_torch(_drift_chain_graph(K=24)[0], "cpu")
    V, F = posegraph.optimize_essential_graph(graph, n_iters=15)
    Vp, Fp = posegraph.optimize_essential_graph(dist_posegraph.pad_graph_edges_to_multiple(graph, 7), n_iters=15)
    assert torch.equal(V.R, Vp.R) and torch.equal(V.t, Vp.t) and torch.equal(V.s, Vp.s) and torch.equal(F, Fp)
