"""One rank of the port's two-process sharded solve (tests/test_torch_multihost.py).

Launched as N separate processes joined over a localhost TCP store
(`multihost.initialize`, gloo on the CPU), each holding one shard of
`multihost.global_mesh()`. Every rank builds the same problems from a seed
with numpy, cuts its shard with `multihost.put_global`, runs the sharded
point-major BA and essential graph, and writes what it got.

Usage: python torch_mp_worker.py <rank> <num_processes> <port> <out_prefix>
"""

import sys

import numpy as np
import torch


def build_problems(seed: int = 0, K: int = 6, P: int = 203, D: int = 4, n_ring: int = 16):
    """A point-major BA problem (P rows, D observations each, stereo, noisy)
    and a drifted Sim3 ring with one loop edge, as numpy, alike in every
    process. P is not a multiple of the ranks, so the row blocks differ."""
    from orbslam2_tpu_torch.geometry import camera, sim3
    from orbslam2_tpu_torch.ops import ba, posegraph

    rng = np.random.default_rng(seed)
    cam = camera.make_camera(458.0, 457.0, 376.0, 240.0, bf=47.9)
    poses = np.tile(np.eye(4, dtype=np.float32), (K, 1, 1))
    poses[:, 0, 3] = -0.25 * np.arange(K)
    points = rng.uniform([-3, -2, 4], [3, 2, 15], (P, 3)).astype(np.float32)
    obs_kf = np.stack([rng.permutation(K)[:D] for _ in range(P)])
    pc = points[:, None, :] + poses[obs_kf, :3, 3]
    u = cam.fx * pc[..., 0] / pc[..., 2] + cam.cx
    v = cam.fy * pc[..., 1] / pc[..., 2] + cam.cy
    obs = np.stack([u, v, u - cam.bf / pc[..., 2]], -1) + rng.normal(0, 0.3, (P, D, 3))
    bap = ba.BAProblemPM(
        poses=poses, points=(points + rng.normal(0, 0.05, points.shape)).astype(np.float32),
        obs_kf=obs_kf.astype(np.int64), obs=obs.astype(np.float32), inv_sigma2=np.ones((P, D), np.float32),
        is_stereo=np.ones((P, D), bool), edge_valid=rng.uniform(size=(P, D)) < 0.95,
        pose_fixed=np.arange(K) == 0,
    )
    ang = 2 * np.pi * np.arange(n_ring) / n_ring
    R = np.stack([[[np.cos(a), 0, -np.sin(a)], [0, 1, 0], [np.sin(a), 0, np.cos(a)]] for a in ang])
    t = -np.einsum("kij,kj->ki", R, np.stack([4 * np.cos(ang), 0 * ang, 4 * np.sin(ang)], -1))
    t_est = t + np.cumsum(rng.normal(0, 0.02, (n_ring, 3)), axis=0)
    ei, ej = np.arange(n_ring), (np.arange(n_ring) + 1) % n_ring
    Rji = np.einsum("eab,ecb->eac", R[ej], R[ei])
    tji = t[ej] - np.einsum("eab,eb->ea", Rji, t[ei])
    pgp = posegraph.PoseGraphProblem(
        vertices=sim3.Sim3(R, t_est, np.ones(n_ring)), edge_i=ei, edge_j=ej,
        meas=sim3.Sim3(Rji, tji, np.ones(n_ring)), edge_valid=np.ones(n_ring, bool),
        fixed=np.arange(n_ring) == 0,
    )
    return cam, bap, pgp


def solve(mesh, cam, bap, pgp):
    """The sharded BA and essential graph on `mesh` -> dict of numpy."""
    from orbslam2_tpu_torch.parallel import dist_ba, dist_posegraph, multihost

    res = dist_ba.make_distributed_ba_pm(mesh, cam, n_iters_first=3, n_iters_second=5, n_cg=12)(
        multihost.put_global(bap, dist_ba.PM_SPECS, mesh))
    V, F = dist_posegraph.make_distributed_posegraph(mesh, n_iters=6, fix_scale=False)(
        multihost.put_global(pgp, dist_posegraph.PG_SPECS, mesh))
    out = dict(poses=res.poses, points=res.points, inlier=res.edge_inlier, chi2=res.final_chi2,
               R=V.R, t=V.t, s=V.s, F=F)
    return {k: multihost.fetch_replicated(v) for k, v in out.items()}


def main():
    rank, n, port, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    torch.set_num_threads(1)
    import torch.distributed as dist

    from orbslam2_tpu_torch.parallel import multihost

    device = multihost.initialize(f"localhost:{port}", n, rank)
    assert device.type == "cpu" and dist.get_backend() == "gloo"
    mesh = multihost.global_mesh()
    assert mesh.size == n and mesh.local_shards() == [rank]
    np.savez(f"{out}{rank}.npz", **solve(mesh, *build_problems()))
    dist.destroy_process_group()
    print(f"[rank {rank}] OK", flush=True)


if __name__ == "__main__":
    main()
