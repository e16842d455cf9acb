"""The port's loop closer with a device mesh (`LoopCloser(mesh=...)`,
`System(mesh=...)`), on the CPU.

  * one loop correction on the hand-built ring map of
    tests/test_torch_loop_closing.py, through a `LoopCloser` on a 4-shard
    CPU mesh and through one without a mesh, from the same map and the
    same loop constraint: the same corrected group and fused pairs, and
    the keyframe poses after the essential graph within 1e-6 (float64
    solves that differ in the order of the cross-shard sums only, written
    back as float32 poses); the sharded solver was built and used;
  * the global BA that follows on the mesh closer goes through the sharded
    solver (`_dist_gba`: the JAX package's 5 + 10 iterations, 20 PCG
    steps) and equals a single-device `ba_solve_pm` with that schedule on
    the same problem within the summation order (poses 5e-5, points 1e-3,
    the same inlier edges); the map holds its poses;
  * a 1-shard mesh takes the single-device path; `System(mesh=...)` routes
    the mesh to its loop closer.
"""

import os

import numpy as np
import pytest
import torch
from _torch_parity import slam_config
from test_torch_loop_closing import N_KF, _build_ring_maps, _closers, _observations_of

from orbslam2_tpu_torch import config as torch_config
from orbslam2_tpu_torch import convert
from orbslam2_tpu_torch.datasets.synthetic import SyntheticWorld
from orbslam2_tpu_torch.ops import ba
from orbslam2_tpu_torch.parallel import dist_ba
from orbslam2_tpu_torch.parallel.mesh import Mesh, make_mesh
from orbslam2_tpu_torch.slam import loop_closing
from orbslam2_tpu_torch.slam.loop_closing import LoopCloser
from orbslam2_tpu_torch.slam.system import System

VOCAB = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "assets", "vocab_circuit.npz")


def _port_closer(mesh):
    cfg, maps, constraint, _ = _build_ring_maps()
    tl = _closers(cfg, maps)[1]
    closer = LoopCloser(cfg, tl.frontend, tl.map, tl.reloc, mesh=mesh)
    for name, value in constraint.items():
        setattr(closer, name, value)
    return closer


def _correct(closer):
    kf = N_KF - 1
    with closer.lock:
        pg_args, fuse_args = closer._correct_loop_locked(kf)
    before = _observations_of(closer.map)
    links = closer._search_and_fuse(kf, *fuse_args)
    fused = sorted(set(_observations_of(closer.map)) - set(before))
    closer._optimize_essential_graph(kf, *pg_args, links)
    poses = {k: closer.map.kf_pose[k].copy() for k in sorted(closer.map.kf_valid)}
    return dict(group=fuse_args[0], fused=fused, links=links, poses=poses)


@pytest.fixture(scope="module")
def corrections():
    torch.set_num_threads(1)
    single = _correct(_port_closer(None))
    closer = _port_closer(make_mesh(4, device="cpu"))
    assert closer.mesh is not None and closer.mesh.size == 4 and closer._dist_pg is None
    meshed = _correct(closer)
    return single, meshed, closer


def test_loop_correction_on_a_mesh_matches_single(corrections):
    single, meshed, closer = corrections
    assert closer._dist_pg is not None
    assert meshed["group"] == single["group"] and meshed["fused"] == single["fused"]
    assert meshed["links"] == single["links"] and meshed["links"]
    assert sorted(meshed["poses"]) == sorted(single["poses"])
    for k, T in single["poses"].items():
        np.testing.assert_allclose(meshed["poses"][k], T, atol=1e-6, err_msg=str(k))


def test_global_ba_on_a_mesh_goes_through_the_sharded_solver(corrections):
    _, _, closer = corrections
    seen, real = [], dist_ba.make_distributed_ba_pm

    def recording(mesh, cam, **kw):
        solve = real(mesh, cam, **kw)

        def run(prob):
            res = solve(prob)
            seen.append((prob, kw, res))
            return res
        return run

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(loop_closing.dist_ba, "make_distributed_ba_pm", recording)
        closer._global_ba(N_KF - 1)
    assert len(seen) == 1 and closer._dist_gba is not None and closer.n_gba_aborted == 0
    prob, kw, res = seen[0]
    assert kw == dict(n_iters_first=5, n_iters_second=10)
    single = ba.ba_solve_pm(convert.ba_problem_pm_to_torch(prob, "cpu"), closer._cam, n_iters_first=5,
                            n_iters_second=10)
    np.testing.assert_allclose(res.poses.numpy(), single.poses.numpy(), atol=5e-5)
    np.testing.assert_allclose(res.points.numpy(), single.points.numpy(), atol=1e-3)
    assert torch.equal(res.edge_inlier, single.edge_inlier)
    m = closer.map
    kfs = sorted(m.kf_valid)
    free = [i for i, k in enumerate(kfs) if not bool(prob.pose_fixed[i])]
    assert free
    for i in free:
        np.testing.assert_array_equal(m.kf_pose[kfs[i]], res.poses[i].numpy())


def test_one_shard_mesh_is_the_single_device_path_and_system_takes_a_mesh():
    closer = _port_closer(Mesh(["cpu"]))
    assert closer.mesh is None
    cfg = slam_config(SyntheticWorld(n_points=10, seed=0), torch_config)
    mesh = make_mesh(2, device="cpu")
    s = System(VOCAB, cfg, mesh=mesh, device="cpu")
    assert s.loop_closer.mesh is mesh and s.tracker.frontend.device == torch.device("cpu")
    s.shutdown()
