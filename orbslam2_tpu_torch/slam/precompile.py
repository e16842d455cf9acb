"""Warm-up of the rare-event device programs (`System.precompile`).

Port of orbslam2_tpu/slam/system.py::System.precompile (:213-474). The JAX
package compiles each program at its shape buckets so that no compile lands
mid-run. Eager PyTorch compiles nothing, but a card pays its own first-use
costs: the CUDA context, each kernel's module (loaded at its first launch),
and the cuSOLVER and cuBLAS handles of the float64 solvers, made at their
first call. On the card the first relocalization took 1178 ms against 219
ms warm, and the first `Sim3 detection` 4974 ms against a 38 ms mean
(PERF.md). `warm` runs each such program once, on the System's device at
its configured sizes, on dummy inputs made from a fixed seed:

  * every kernel library built and loaded;
  * K2, K6, K1 and K3 `stereo` through one frontend call on a textured pair;
  * K3 `frame`, `points`, `mask`, `fuse` and `nodes`, and K5;
  * K4, when the System has a vocabulary;
  * the float64 solvers: EPnP and MLPnP RANSAC, the Sim3 RANSAC and LM, the
    essential graph, and the point-major BA step at n_cg 20 and 40;
  * the float64 `torch.linalg` calls the solvers make.

Any failure raises. Nothing of the System changes: the map, the keyframe
database, the trajectory and the tracker are not touched, the solvers draw
from a generator of their own, and every kernel's launch counter is set
back to its value before the call (launches made meanwhile by another
thread, a threaded mapper's, would be lost from the counts: call it while
the System is idle). The two-view initializer of the monocular sensor is
not warmed.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..geometry import se3, sim3
from ..kernels import build
from ..ops import ba, fast, hamming, matchers, mlpnp, orb, patches, pnp, pose_opt, posegraph, sim3solve
from ..vocab import bow
from . import relocalization
from .loop_closing import N_HYP

#: the wrappers whose `launches` attribute counts kernel launches (an int,
#: or a dict of counts per mode or caller)
COUNTED = (
    (fast, "fast_nms_levels"), (patches, "orb_patch_desc_levels"), (orb, "select_keypoints_levels"),
    (pose_opt, "pose_optimize"), (bow, "transform_words_nodes"), (hamming, "best2"), (hamming, "best2_gated"),
)


def launch_counts() -> list:
    """A copy of every counted wrapper's launch counter."""
    return [(owner, name, _copy(getattr(owner, name).launches)) for owner, name in COUNTED]


def restore_launch_counts(saved: list) -> None:
    for owner, name, value in saved:
        fn = getattr(owner, name)
        if isinstance(value, dict):
            fn.launches.clear()
            fn.launches.update(value)
        else:
            fn.launches = value


def _copy(v):
    return dict(v) if isinstance(v, dict) else v


def _scene(rng, n: int, cam):
    """n points in front of a camera at the identity pose: (world points
    [n, 3], their pixels [n, 2]) as float32 numpy."""
    X = rng.uniform([-2.0, -1.5, 4.0], [2.0, 1.5, 8.0], (n, 3)).astype(np.float32)
    uv = np.stack([cam.fx * X[:, 0] / X[:, 2] + cam.cx, cam.fy * X[:, 1] / X[:, 2] + cam.cy], 1)
    return X, uv.astype(np.float32)


def warm(system) -> float:
    """Run every rare-event program of `system` once; returns the seconds it
    took (the device synchronised at the end)."""
    t0 = time.perf_counter()
    saved = launch_counts()
    try:
        _warm(system)
    finally:
        restore_launch_counts(saved)
    return time.perf_counter() - t0


def _warm(system) -> None:
    dev, cfg, fe = system.device, system.config, system.frontend
    cam = fe.camera
    N = cfg.orb.n_features
    rng = np.random.default_rng(0)
    gen = torch.Generator(device=dev).manual_seed(0)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    if dev.type == "cuda":
        build.load()

    # the front end (K2, K6, K1, K3 stereo) on a textured pair, the right
    # eye the left shifted by 8 px
    H, W = cfg.camera.height, cfg.camera.width
    img = np.kron(rng.uniform(0, 255, (H // 8 + 1, W // 8 + 2)), np.ones((8, 8)))
    pair = np.stack([img[:H, 8:W + 8], img[:H, :W]]).astype(np.float32)
    fd = fe.features_body(t(pair))
    sf, inv_sig2 = fe.scale_factors, fe.inv_level_sigma2

    # the matchers' K3 modes and the pose LM on that frame's features
    matchers.search_by_projection_frame(fd.uv, fd.octave, fd.desc, fd.valid, fd.angle, fd.uv, fd.octave, fd.desc,
                                        fd.valid, fd.angle, sf, 7.0, False, False)
    view_cos = torch.ones_like(fd.angle)
    matchers.search_by_projection_points(fd.uv, fd.octave, fd.u_right, fd.desc, fd.valid, fd.uv, fd.u_right,
                                         fd.octave, view_cos, fd.desc, fd.valid, sf, 1.0)
    matchers.search_by_bow(fd.desc, fd.valid, fd.angle, fd.desc, fd.valid, fd.angle, 0.75)
    matchers.fuse_match(fd.uv, fd.octave, fd.u_right, fd.desc, fd.valid, fd.uv, fd.u_right, fd.octave, fd.desc,
                        fd.valid, sf, inv_sig2, 3.0)
    nodes = torch.arange(N, dtype=torch.int32, device=dev) % 16
    matchers.search_by_bow_nodes(fd.desc, fd.valid, fd.angle, nodes, fd.desc, fd.valid, fd.angle, nodes, 0.75)
    X, uv = _scene(rng, N, cam)
    obs = np.concatenate([uv, uv[:, :1] - cam.bf / X[:, 2:]], 1)
    valid = np.arange(N) < N // 2
    pose_opt.pose_optimize(t(np.eye(4, dtype=np.float32)), t(X), t(obs), t(np.ones(N, np.float32)),
                           t(np.ones(N, bool)), t(valid), cam)
    if system.vocabulary is not None:
        bow.transform_words_nodes(system.vocabulary, fd.desc, fd.valid)

    # relocalization: EPnP RANSAC over the candidates, MLPnP RANSAC
    C = relocalization.CANDIDATES
    obs_n = (X[:, :2] / X[:, 2:]).astype(np.float32)
    max_err2 = np.full(N, 5.991 / (cam.fx * cam.fx), np.float32)
    pnp.pnp_ransac(t(np.broadcast_to(X, (C, N, 3))), t(obs_n), t(np.broadcast_to(valid, (C, N))), t(max_err2), gen)
    bearings = mlpnp.bearings_from_pixels(t(uv), cam.fx, cam.fy, cam.cx, cam.cy)
    cos_th = np.full(N, np.cos(np.sqrt(5.991) / cam.fx), np.float32)
    mlpnp.mlpnp_ransac(t(X), bearings, t(valid), t(cos_th), gen)

    # loop closing: the Sim3 RANSAC and LM, the essential graph
    fix_scale = not cfg.monocular
    R = 200
    X64, uv64 = t(X[:R].astype(np.float64)), t(uv[:R].astype(np.float64))
    me = t(np.full(R, 9.21, np.float64))
    ok = torch.ones(R, dtype=torch.bool, device=dev)
    hyp = pnp.sample_hypotheses(ok, N_HYP, gen, k=3)
    res = sim3solve.sim3_ransac(X64, X64, uv64, uv64, me, me, ok, cam, fix_scale=fix_scale, hypotheses=hyp)
    sim3solve.optimize_sim3(res.S12, X64, X64, uv64, uv64, 9.21 / me, 9.21 / me, res.inliers, cam,
                            fix_scale=fix_scale)
    K, f64 = 16, torch.float64
    xi = t(np.concatenate([rng.normal(0, 0.01, (K, 3)), np.arange(K)[:, None] * [0.0, 0.0, 0.3]], 1))
    T = se3.exp(xi)
    edge_i = torch.arange(K - 1, device=dev)
    vertices = sim3.Sim3(R=T[:, :3, :3], t=T[:, :3, 3], s=torch.ones(K, dtype=f64, device=dev))
    meas = sim3.compose(sim3.Sim3(*(a[edge_i + 1] for a in vertices)),
                        sim3.inverse(sim3.Sim3(*(a[edge_i] for a in vertices))))
    posegraph.optimize_essential_graph(posegraph.PoseGraphProblem(
        vertices=vertices, edge_i=edge_i, edge_j=edge_i + 1, meas=meas,
        edge_valid=torch.ones(K - 1, dtype=torch.bool, device=dev),
        fixed=torch.arange(K, device=dev) == 0), fix_scale=fix_scale)

    # the point-major BA step at the local (n_cg 20) and global (40) depths
    Kb, P, D = 4, 64, 4
    poses = torch.eye(4, device=dev).repeat(Kb, 1, 1)
    poses[:, 2, 3] = -0.2 * torch.arange(Kb, device=dev)
    pts = t(X[:P])
    kf = torch.arange(P * D, device=dev).reshape(P, D) % Kb
    pc = pts[:, None, :] + poses[kf][..., :3, 3]
    u = cam.fx * pc[..., 0] / pc[..., 2] + cam.cx
    prob = ba.BAProblemPM(
        poses=poses, points=pts, obs_kf=kf,
        obs=torch.stack([u, cam.fy * pc[..., 1] / pc[..., 2] + cam.cy, u - cam.bf / pc[..., 2]], -1),
        inv_sigma2=torch.ones(P, D, device=dev), is_stereo=torch.ones(P, D, dtype=torch.bool, device=dev),
        edge_valid=torch.ones(P, D, dtype=torch.bool, device=dev), pose_fixed=torch.arange(Kb, device=dev) == 0)
    seg = ba.camera_segments(prob)
    state = ba.ba_pm_init(prob, cam, seg=seg)
    for n_cg in (20, 40):
        state = ba.ba_pm_step(prob, cam, state, n_cg, seg=seg)
    ba.pm_inlier_mask(state.poses, state.points, prob, cam)

    # the float64 (and the BA's float32) torch.linalg calls, whose solver
    # handles are made at their first call on a device
    A = t(rng.normal(size=(8, 6, 6)))
    S = A @ A.transpose(-1, -2) + 6 * torch.eye(6, dtype=f64, device=dev)
    torch.linalg.eigh(S)
    torch.linalg.svd(A)
    torch.linalg.det(A)
    torch.linalg.inv_ex(S)
    torch.linalg.inv_ex(S.float())
    torch.linalg.solve_ex(S, A)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
