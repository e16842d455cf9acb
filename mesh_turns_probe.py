"""Time the port's sharded point-major BA on in-process meshes.

Builds a stereo BA problem with numpy from `--seed` (`--points` rows,
`--keyframes` poses, 4 observations a row), solves it with
`parallel.dist_ba.make_distributed_ba_pm` (5 + 10 iterations, 20 PCG steps)
on n shards of one device (`Mesh([device] * n)`, each solve ending
synchronised) for each n of `--shards`, one intra-op thread, and prints
one JSON line with each mesh's best wall time over `--rounds` runs (after
one unmeasured solve) and its count of cross-shard reductions. `--repo
DIR` imports `orbslam2_tpu_torch` from another checkout, to compare two
versions of the mesh in one run. `--device cpu` (the default) is a CPU
figure; `--device cuda` puts the shards on card 0, where the figure-8's
recorded global BA is about `--points 16896 --keyframes 138`.

    python3 mesh_turns_probe.py [--shards 1 2 8] [--points 200] [--keyframes 6] [--rounds 3] [--seed 0]
        [--device cpu] [--repo DIR]
"""

import argparse
import json
import platform
import sys
import time

import numpy as np


def build_problem(seed: int, K: int, P: int, D: int = 4):
    """Keyframes 0.25 m apart on a line, P points 4-15 m ahead, each seen by
    D random keyframes with 0.3 px of noise; 5 cm of noise on the points."""
    from orbslam2_tpu_torch.geometry import camera
    from orbslam2_tpu_torch.ops import ba

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
    prob = ba.BAProblemPM(
        poses=poses, points=(points + rng.normal(0, 0.05, points.shape)).astype(np.float32),
        obs_kf=obs_kf.astype(np.int64), obs=obs.astype(np.float32), inv_sigma2=np.ones((P, D), np.float32),
        is_stereo=np.ones((P, D), bool), edge_valid=np.ones((P, D), bool), pose_fixed=np.arange(K) == 0,
    )
    return cam, prob


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--shards", type=int, nargs="+", default=[1, 2, 8])
    ap.add_argument("--points", type=int, default=200)
    ap.add_argument("--keyframes", type=int, default=6)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cpu", help="cpu, or cuda for card 0")
    ap.add_argument("--repo", default=None, help="import orbslam2_tpu_torch from this checkout")
    args = ap.parse_args(argv)
    if args.repo:
        sys.path.insert(0, args.repo)

    import torch

    from orbslam2_tpu_torch.parallel import dist_ba, mesh

    torch.set_num_threads(1)
    cam, prob = build_problem(args.seed, args.keyframes, args.points)
    device = torch.device(args.device)
    prob = type(prob)(*(torch.as_tensor(x).to(device) for x in prob))
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    counted = {"n": 0}
    for name in ("ShardReducer", "GroupReducer"):
        cls = getattr(mesh, name)
        for op in ("sum", "max"):
            def counting(self, x, _f=getattr(cls, op)):
                counted["n"] += 1
                return _f(self, x)
            setattr(cls, op, counting)
    out = {}
    for n in args.shards:
        solve = dist_ba.make_distributed_ba_pm(mesh.Mesh([device] * n), cam)
        solve(prob)
        best = float("inf")
        for _ in range(args.rounds):
            counted["n"] = 0
            sync()
            t0 = time.perf_counter()
            solve(prob)
            sync()
            best = min(best, time.perf_counter() - t0)
        out[n] = {"best_s": best, "reductions_per_shard": counted["n"] / n}
    where = torch.cuda.get_device_name(0) if device.type == "cuda" else platform.processor() or platform.machine()
    print(json.dumps({"mesh_module": mesh.__file__, "points": args.points, "keyframes": args.keyframes,
                      "rounds": args.rounds, "device": where, "by_shards": out}))


if __name__ == "__main__":
    main()
