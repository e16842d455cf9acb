"""The port's sharded whole-map solvers (`orbslam2_tpu_torch/parallel/`)
against the JAX package's on its 8-device CPU mesh, on the problems of
tests/test_dist_ba.py, with that file's bars.

  * `dist_ba.make_distributed_ba_pm` on an 8-shard CPU mesh, on
    `tests/test_ba.py::make_bundle(K=6, P=200, noise_px=0.3)` (200 rows
    over 8 shards, no padding), against the JAX package's
    `make_distributed_ba_pm` on the 8-device mesh: poses within 5e-4,
    median point distance < 1e-3. The JAX package casts the camera-side
    operand of its one-hot matmuls to bf16; the port sums in fp32 (ROADMAP
    queue 3 watch list), which alone moves the median point 2.3e-3 on this
    problem. So the JAX solver runs here with those three helpers in fp32
    (`_pm_onehot`, `_pm_mm`, `_pm_camera_gather`, patched for the test).
  * the same sharded solve against the port's single-device `ba_solve_pm`
    on the same problem: they differ by the order of the cross-shard sums
    only, so poses within 5e-5 and every point within 1e-3, chi2 within
    1e-5 relative and the same inlier edges.
  * `dist_posegraph.make_distributed_posegraph` on a 2-shard CPU mesh,
    on `tests/test_dist_ba.py::_drift_chain_graph(K=24)`, against the JAX
    package's on the 8-device mesh, with a fixed and with a free scale:
    R and t within 1e-3, the cost within 1e-3 relative, and the drift
    corrected (end error under half the initial drift).

The inputs are made with numpy from a seed (0).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_ba import make_bundle
from test_dist_ba import _drift_chain_graph

from orbslam2_tpu.ops import ba as jba
from orbslam2_tpu.parallel import dist_ba as jdist_ba
from orbslam2_tpu.parallel import dist_posegraph as jdist_pg
from orbslam2_tpu.parallel import mesh as jmesh
from orbslam2_tpu_torch import convert
from orbslam2_tpu_torch.geometry import camera as tcamera
from orbslam2_tpu_torch.ops import ba as tba
from orbslam2_tpu_torch.parallel import dist_ba, dist_posegraph, mesh

# six xdist workers share the machine: one intra-op thread each (each
# shard's thread runs its ops on it)
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def bundle():
    """(JAX camera, JAX point-major problem as numpy, the port's camera,
    the port's 8-shard result)."""
    jcam, prob, *_ = make_bundle(np.random.default_rng(0), K=6, P=200, noise_px=0.3)
    pm = jax.device_get(jba.coo_to_pm(prob))
    tcam = tcamera.make_camera(jcam.fx, jcam.fy, jcam.cx, jcam.cy, bf=jcam.bf)
    m8 = mesh.make_mesh(8, device="cpu")
    assert m8.size == 8
    return jcam, pm, tcam, dist_ba.make_distributed_ba_pm(m8, tcam)(pm)


def _f32_one_hot_matmuls(monkeypatch):
    hi = jax.lax.Precision.HIGHEST
    monkeypatch.setattr(jba, "_pm_onehot",
                        lambda prob, K: jax.nn.one_hot(prob.obs_kf.reshape(-1), K, dtype=jnp.float32))
    monkeypatch.setattr(jba, "_pm_mm",
                        lambda A, x: jax.lax.dot_general(A, x, (((0,), (0,)), ((), ())), precision=hi))
    monkeypatch.setattr(jba, "_pm_camera_gather",
                        lambda A, vc: jax.lax.dot_general(A, vc, (((1,), (0,)), ((), ())), precision=hi))


def test_ba_pm_sharded_matches_jax(bundle, monkeypatch):
    jcam, pm, _, got = bundle
    _f32_one_hot_matmuls(monkeypatch)
    jm = jmesh.make_mesh()
    assert jm.devices.size == 8
    want = jdist_ba.make_distributed_ba_pm(jm, jcam)(jdist_ba.pad_points_to_multiple(pm, 8))
    np.testing.assert_allclose(got.poses.numpy(), np.asarray(want.poses), atol=5e-4)
    P = pm.points.shape[0]
    assert got.points.shape == (P, 3)
    d = np.linalg.norm(got.points.numpy() - np.asarray(want.points)[:P], axis=1)
    assert np.median(d) < 1e-3
    assert abs(float(got.final_chi2) - float(want.final_chi2)) < 1e-3 * float(want.final_chi2)


def test_ba_pm_sharded_matches_single(bundle):
    _, pm, tcam, got = bundle
    single = tba.ba_solve_pm(convert.ba_problem_pm_to_torch(pm, "cpu"), tcam)
    np.testing.assert_allclose(got.poses.numpy(), single.poses.numpy(), atol=5e-5)
    np.testing.assert_allclose(got.points.numpy(), single.points.numpy(), atol=1e-3)
    assert abs(float(got.final_chi2) - float(single.final_chi2)) < 1e-5 * float(single.final_chi2)
    assert torch.equal(got.edge_inlier, single.edge_inlier)


@pytest.mark.parametrize("fix_scale", [True, False])
def test_posegraph_sharded_matches_jax(fix_scale):
    jprob, gt = _drift_chain_graph(K=24)
    want_V, want_F = jdist_pg.make_distributed_posegraph(jmesh.make_mesh(), n_iters=15, fix_scale=fix_scale)(
        jdist_pg.pad_graph_edges_to_multiple(jprob, 8))
    V, F = dist_posegraph.make_distributed_posegraph(mesh.make_mesh(2, device="cpu"), n_iters=15, fix_scale=fix_scale)(
        convert.pose_graph_to_torch(jprob, "cpu"))
    np.testing.assert_allclose(V.t.numpy(), np.asarray(want_V.t), atol=1e-3)
    np.testing.assert_allclose(V.R.numpy(), np.asarray(want_V.R), atol=1e-3)
    assert abs(float(F) - float(want_F)) < 1e-3 * max(1.0, abs(float(want_F)))
    if fix_scale:
        assert torch.equal(V.s, torch.ones_like(V.s))
    # the drift corrected: camera centre -R^T t / s of the last vertex
    centre = lambda R, t, s: -R.T @ (t / s)  # noqa: E731
    c_gt = -gt[-1][:3, :3].T @ gt[-1][:3, 3]
    c0 = centre(np.asarray(jprob.vertices.R)[-1], np.asarray(jprob.vertices.t)[-1], 1.0)
    c1 = centre(V.R[-1].numpy(), V.t[-1].numpy(), float(V.s[-1]))
    assert np.linalg.norm(c1 - c_gt) < 0.5 * np.linalg.norm(c0 - c_gt)
