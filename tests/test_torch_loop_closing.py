"""The port's loop closing against the JAX package's, on the CPU.

  * `matchers.search_by_bow_nodes` (K3 `nodes` mode's plain version under
    it) and `bow_node_matches` against the JAX package's
    `search_by_bow_nodes` and its loop closer's collision resolution, on
    K3's `nodes` edge cases of 300 rows and on near-duplicate descriptors:
    identical
    idx / best / keep / winners. The kernel's candidate rule (the column
    node ids sorted, each row binary-searching its node and scanning only
    that node's slots) in plain PyTorch: identical to the plain version on
    every `nodes` edge case.
  * `optimize_essential_graph` on the 24-vertex drifted ring of
    tests/test_sim3_posegraph.py::test_loop_closure_corrects_drift:
    vertices within 1e-3 m (camera centres) and 1e-3 rad, and the drift
    corrected as that test requires. The port solves in float64, the JAX
    package in float32.
  * one loop correction on one hand-built ring map, written into a JAX
    and a port `SlamMap` through the same calls, with the same loop
    constraint (`_Scw`, `_matched_kf`, `_matched_points`, `_loop_points`)
    set on both closers: the same corrected group and pose propagation
    (1e-5), identical fused pairs and new loop connections after
    SearchAndFuse, keyframe poses after the essential graph within 1e-3 m
    (camera centres) and 1e-3 rad. Each corrected keyframe sees fewer than
    256 loop points, below the JAX package's loop-fusion cap.
  * `slow`, never in Tier-1: the port twin of tests/test_loop_closing.py,
    the same 150-frame circuit and the same trained vocabulary (k = 8,
    depth 3, carried across with `convert.vocabulary_to_torch`), with the
    same bars: every frame tracked, >= 1 loop, >= 2 loop edges, ATE < 0.30 m.

The JAX essential graph is compiled once: the ring is padded to the shape
bucket the JAX loop closer pads the ring map's graph to (32 vertices, 64
edges).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import desc_both, np_of, rot_err, slam_config

from orbslam2_tpu import config as jax_config
from orbslam2_tpu.geometry import sim3 as jsim3
from orbslam2_tpu.ops import matchers as jmatch
from orbslam2_tpu.ops import posegraph as jpg
from orbslam2_tpu.slam.frontend import FrameFeatures as JaxFeatures
from orbslam2_tpu.slam.frontend import FrameHost as JaxFrameHost
from orbslam2_tpu.slam.frontend import Frontend as JaxFrontend
from orbslam2_tpu.slam.loop_closing import LoopCloser as JaxCloser
from orbslam2_tpu.slam.map import SlamMap as JaxMap
from orbslam2_tpu.slam.relocalization import Relocalizer as JaxRelocalizer
from orbslam2_tpu.vocab import bow as jax_bow
from orbslam2_tpu_torch import config as torch_config
from orbslam2_tpu_torch import convert
from orbslam2_tpu_torch.datasets.synthetic import SyntheticWorld
from orbslam2_tpu_torch.geometry import se3 as tse3
from orbslam2_tpu_torch.kernels import cases
from orbslam2_tpu_torch.ops import hamming, matchers, posegraph
from orbslam2_tpu_torch.slam.frontend import FrameFeatures, FrameHost, Frontend
from orbslam2_tpu_torch.slam.loop_closing import LoopCloser
from orbslam2_tpu_torch.slam.map import SlamMap
from orbslam2_tpu_torch.slam.relocalization import Relocalizer

PG_SHAPE = (32, 64)  # the JAX loop closer's bucket for the ring map's graph


def _centers(R, t, s):
    """Camera centres [K, 3] of Sim3 vertices (the SE(3) pose [R | t/s])."""
    R, t, s = (np.asarray(np_of(a), np.float64) for a in (R, t, s))
    return -np.einsum("kji,kj->ki", R, t / s[:, None])


# ---------------------------------------------------------------------------
# FeatureVector-bucketed BoW matching (K3 `nodes` mode)
# ---------------------------------------------------------------------------


def _nodes_inputs():
    """The `nodes` edge cases of kernels/cases.py, plus a case of
    near-duplicate descriptors in shared nodes (so that matches pass the
    ratio and TH_LOW gates): (name, A, B, gate fields, angle_a, angle_b)."""
    rng = np.random.default_rng(11)
    out = []
    for name, A, B, g in cases.k3_cases("cpu"):
        # one shape, so that the JAX function compiles once
        if isinstance(g, hamming.Gate) and g.mode == "nodes" and tuple(A.shape) == (300, 8):
            out.append((name, np_of(A), np_of(B), {k: np_of(getattr(g, k)) for k in
                                                    ("row_valid", "col_valid", "row_node", "col_node")}))
    A, B, g = cases.nodes_case(rng, 300, 400, 60)
    flip = (np.uint32(1) << rng.integers(0, 32, (250, 8)).astype(np.uint32)) * (rng.uniform(size=(250, 8)) < 0.6)
    B[:250] = (A[:250].view(np.uint32) ^ flip.astype(np.uint32)).view(np.int32)
    g["col_node"][:250] = g["row_node"][:250]
    out.append(("near duplicates", A, B, g))
    res = []
    for name, A, B, g in out:
        ang_a = rng.uniform(0, 6.28, len(A)).astype(np.float32)
        ang_b = rng.uniform(0, 6.28, len(B)).astype(np.float32)
        k = min(len(A), len(B))
        ang_b[:k] = ang_a[:k] + rng.normal(0, 0.05, k).astype(np.float32)
        res.append((name, A, B, g, ang_a, ang_b))
    return res


def _jax_bow_nodes(*args):
    """The JAX package's search_by_bow_nodes, then its loop closer's
    collision resolution (`_bow_batch`, loop_closing.py:137-143)."""
    idx, best, keep = jmatch.search_by_bow_nodes(*args)
    src2, _ = jmatch._resolve_collisions(idx, jnp.where(keep, best, hamming.MAX_DIST), args[4].shape[0])
    return idx, best, keep, keep & (src2[idx] == jnp.arange(idx.shape[0]))


def test_search_by_bow_nodes_matches_jax():
    jfn = jax.jit(_jax_bow_nodes)
    kept = 0
    for name, A, B, g, ang_a, ang_b in _nodes_inputs():
        (ja, ta), (jb, tb) = desc_both(A.view(np.uint32)), desc_both(B.view(np.uint32))
        jidx, jbest, jkeep, jwin = jfn(ja, g["row_valid"], ang_a, g["row_node"], jb, g["col_valid"], ang_b,
                                       g["col_node"], 0.75)
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
        targs = (ta, t(g["row_valid"]), t(ang_a), t(g["row_node"]), tb, t(g["col_valid"]), t(ang_b),
                 t(g["col_node"]), 0.75)
        tidx, tbest, tkeep = matchers.search_by_bow_nodes(*targs)
        np.testing.assert_array_equal(np_of(tidx), np.asarray(jidx), err_msg=name)
        np.testing.assert_array_equal(np_of(tbest), np.asarray(jbest), err_msg=name)
        np.testing.assert_array_equal(np_of(tkeep), np.asarray(jkeep), err_msg=name)
        kept += int(np.asarray(jkeep).sum())
        _, win = matchers.bow_node_matches(*targs)
        np.testing.assert_array_equal(np_of(win), np.asarray(jwin), err_msg=name)
    assert kept > 100


def test_node_range_scan_equals_plain():
    """K3 `nodes` mode's algorithm in plain PyTorch: the column node ids
    sorted (torch.sort, as the wrapper does), each valid row with a node
    >= 0 binary-searching it (searchsorted) and scanning only its slots,
    the gate (column valid) checked per candidate, keys (d << 32) | j.
    Equal to the plain version on every `nodes` edge case."""
    for name, A, B, g in cases.k3_cases("cpu"):
        if not (isinstance(g, hamming.Gate) and g.mode == "nodes"):
            continue
        want = hamming.best2_gated_plain(A, B, g)
        ids, perm = torch.sort(g.col_node)
        lo = torch.searchsorted(ids, g.row_node, right=False)
        hi = torch.searchsorted(ids, g.row_node, right=True)
        N = A.shape[0]
        got = torch.zeros((4, N), dtype=torch.int32)
        got[1] = got[3] = hamming.MAX_DIST
        for i in range(N):
            if not (g.row_valid[i] and g.row_node[i] >= 0):
                continue
            j = perm[lo[i]:hi[i]]
            j = j[g.col_valid[j]]
            d = hamming.hamming_pair(A[i][None], B[j]).to(torch.int64)
            keys = torch.sort((d << 32) | j).values
            for slot, k in enumerate(keys[:2].tolist()):
                if k >> 32 < hamming.MAX_DIST:
                    got[2 * slot, i], got[2 * slot + 1, i] = k & 0xFFFFFFFF, k >> 32
        for r in range(4):
            assert torch.equal(got[r], want[r]), name


# ---------------------------------------------------------------------------
# the essential graph
# ---------------------------------------------------------------------------


def _drifted_ring():
    """tests/test_sim3_posegraph.py's ring: 24 keyframes on a 5 m circle,
    odometry with a constant bias, one exact loop edge (K-1 -> 0), vertex 0
    fixed. Returns (vertices R, t, ground truth Tcw, edges i, j, meas R, t)."""
    K = 24
    gt = []
    for k in range(K):
        ang = 2 * np.pi * k / K
        c = np.array([np.cos(ang) * 5, 0.0, np.sin(ang) * 5])
        Rwc = tse3.exp_so3(torch.tensor([0.0, -ang, 0.0], dtype=torch.float32)).numpy()
        Tcw = np.eye(4, dtype=np.float32)
        Tcw[:3, :3] = Rwc.T
        Tcw[:3, 3] = -Rwc.T @ c
        gt.append(Tcw)
    gt = np.stack(gt)
    bias = torch.tensor([0.002, -0.001, 0.003, 0.01, 0.005, -0.008]) * 4
    est, meas = [gt[0]], []
    for k in range(K - 1):
        T_noisy = tse3.exp(bias).numpy() @ (gt[k + 1] @ np.linalg.inv(gt[k]))
        meas.append(T_noisy)
        est.append(T_noisy @ est[-1])
    meas.append(gt[0] @ np.linalg.inv(gt[K - 1]))
    est, meas = np.stack(est).astype(np.float32), np.stack(meas).astype(np.float32)
    ei = np.r_[np.arange(K - 1), K - 1].astype(np.int32)
    ej = np.r_[np.arange(1, K), 0].astype(np.int32)
    return est[:, :3, :3], est[:, :3, 3], gt, ei, ej, meas[:, :3, :3], meas[:, :3, 3]


def _padded_problem(Rv, tv, ei, ej, mR, mt, fixed):
    """A JAX PoseGraphProblem padded to PG_SHAPE as the JAX loop closer pads
    (identity vertices fixed, invalid identity edges)."""
    Kp, Ep = PG_SHAPE
    K, E = len(Rv), len(ei)
    pad = lambda a, n, fill: np.concatenate([a, np.broadcast_to(fill, (n - len(a),) + a.shape[1:])])  # noqa: E731
    eye = np.eye(3, dtype=np.float32)
    return jpg.PoseGraphProblem(
        vertices=jsim3.Sim3(R=jnp.asarray(pad(Rv, Kp, eye)), t=jnp.asarray(pad(tv, Kp, 0.0)),
                            s=jnp.ones(Kp)),
        edge_i=jnp.asarray(pad(ei, Ep, 0)), edge_j=jnp.asarray(pad(ej, Ep, 0)),
        meas=jsim3.Sim3(R=jnp.asarray(pad(mR, Ep, eye)), t=jnp.asarray(pad(mt, Ep, 0.0)), s=jnp.ones(Ep)),
        edge_valid=jnp.asarray(np.arange(Ep) < E), fixed=jnp.asarray(pad(fixed, Kp, True)),
    ), K


def test_essential_graph_matches_jax():
    Rv, tv, gt, ei, ej, mR, mt = _drifted_ring()
    K = len(Rv)
    prob, _ = _padded_problem(Rv, tv, ei, ej, mR, mt, np.arange(K) == 0)
    Vj, _ = jpg.optimize_essential_graph_jit(prob, fix_scale=True)
    Vt, _ = posegraph.optimize_essential_graph(convert.pose_graph_to_torch(prob, "cpu"), fix_scale=True)
    cj, ct = _centers(*Vj)[:K], _centers(*Vt)[:K]
    assert np.abs(cj - ct).max() < 1e-3
    for k in range(K):
        assert rot_err(np.asarray(Vj.R[k]), np_of(Vt.R[k])) < 1e-3, k
    # the drift is corrected as tests/test_sim3_posegraph.py requires
    drift = np.linalg.norm(_centers(Rv, tv, np.ones(K))[-1] + gt[-1][:3, :3].T @ gt[-1][:3, 3])
    err_end = np.linalg.norm(ct[-1] + gt[-1][:3, :3].T @ gt[-1][:3, 3])
    assert err_end < 0.5 * drift


# ---------------------------------------------------------------------------
# one loop correction on a hand-built ring map
# ---------------------------------------------------------------------------

N_KF = 20  # keyframes on the ring; the last closes the loop on the first
N_SLOTS = 256  # feature slots per keyframe
N_WORLD = 1500  # world points on the wall


def _ring_world(rng):
    """Ground-truth camera poses (Tcw) on a 5 m circle looking outward, and
    world points on an 11 m cylinder around it with one random descriptor
    each and one octave each."""
    gt = []
    for k in range(N_KF):
        ang = 2 * np.pi * k / N_KF
        c = np.array([5 * np.cos(ang), 0.0, 5 * np.sin(ang)])
        z = np.array([np.cos(ang), 0.0, np.sin(ang)])  # optical axis: outward
        y = np.array([0.0, 1.0, 0.0])
        x = np.cross(y, z)
        Rwc = np.stack([x, y, z], axis=1)
        T = np.eye(4)
        T[:3, :3] = Rwc.T
        T[:3, 3] = -Rwc.T @ c
        gt.append(T)
    phi = rng.uniform(0, 2 * np.pi, N_WORLD)
    pts = np.stack([11 * np.cos(phi), rng.uniform(-2.5, 2.5, N_WORLD), 11 * np.sin(phi)], axis=1)
    desc = rng.integers(0, 2**32, (N_WORLD, 8), dtype=np.uint64).astype(np.uint32)
    octave = rng.integers(0, 3, N_WORLD).astype(np.int32)
    return np.stack(gt), pts, desc, octave


def _drift(k):
    """The map's accumulated drift at keyframe k: a world-frame transform
    (a yaw of k x 0.1 degrees and k x 0.6 cm sideways)."""
    a = np.deg2rad(0.1) * k
    D = np.eye(4)
    D[:3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]
    D[:3, 3] = [0.006 * k, 0.001 * k, 0.0]
    return D


def _observations(rng, cam, Tcw, pts, desc, octave):
    """A keyframe's features of the world points it sees (at most N_SLOTS,
    nearest first): world point ids per slot and the feature arrays."""
    pc = pts @ Tcw[:3, :3].T + Tcw[:3, 3]
    z = pc[:, 2]
    u = cam.fx * pc[:, 0] / np.maximum(z, 1e-9) + cam.cx
    v = cam.fy * pc[:, 1] / np.maximum(z, 1e-9) + cam.cy
    seen = np.nonzero((z > 0.5) & (u >= 20) & (u < cam.width - 20) & (v >= 20) & (v < cam.height - 20))[0]
    seen = seen[np.argsort(z[seen], kind="stable")][:N_SLOTS]
    n = len(seen)
    uv = np.zeros((N_SLOTS, 2), np.float32)
    uv[:n, 0] = u[seen] + rng.normal(0, 0.3, n)
    uv[:n, 1] = v[seen] + rng.normal(0, 0.3, n)
    depth = np.full(N_SLOTS, -1.0, np.float32)
    depth[:n] = z[seen]
    u_right = np.full(N_SLOTS, -1.0, np.float32)
    u_right[:n] = uv[:n, 0] - cam.bf / depth[:n]
    d = np.zeros((N_SLOTS, 8), np.uint32)
    flips = (np.uint32(1) << rng.integers(0, 32, (n, 8)).astype(np.uint32)) * (rng.uniform(size=(n, 8)) < 0.3)
    d[:n] = desc[seen] ^ flips.astype(np.uint32)
    oct_ = np.zeros(N_SLOTS, np.int32)
    oct_[:n] = octave[seen]
    valid = np.zeros(N_SLOTS, bool)
    valid[:n] = True
    fields = dict(uv=uv, octave=oct_, angle=np.zeros(N_SLOTS, np.float32),
                  response=np.ones(N_SLOTS, np.float32), desc=d, valid=valid, u_right=u_right, depth=depth)
    return seen, fields


def _build_ring_maps():
    """The same ring map in a JAX and a port SlamMap, through the same
    calls: keyframe k at its drifted pose, its features associated with the
    points its recent predecessors made (a point first made by a keyframe
    more than N_KF / 2 away is made again: the duplicates a loop closes),
    the rest made from stereo, then its connections updated."""
    rng = np.random.default_rng(4)
    gt, pts, desc, octave = _ring_world(rng)
    cfg = slam_config(SyntheticWorld(n_points=10, seed=1, baseline=0.2), torch_config)
    cam = cfg.camera
    maps, frames = (JaxMap(N_SLOTS), SlamMap(N_SLOTS)), ([], [])
    made = {}  # world point -> (map point id, keyframe that made it)
    for k in range(N_KF):
        Tcw_est = gt[k] @ np.linalg.inv(_drift(k))
        seen, f = _observations(rng, cam, gt[k], pts, desc, octave)
        point_ids = np.full(N_SLOTS, -1, np.int64)
        for slot, w in enumerate(seen):
            if w in made and k - made[w][1] <= N_KF // 2:
                point_ids[slot] = made[w][0]
        new = np.nonzero((point_ids < 0) & f["valid"])[0]
        jf = JaxFrameHost(JaxFeatures(**{n: jnp.asarray(a) for n, a in f.items()}), float(k), k)
        tf = FrameHost(FrameFeatures(**{n: (convert.desc_to_torch(a, "cpu") if n == "desc" else
                                            torch.from_numpy(a)) for n, a in f.items()}), float(k), k)
        for m, frame in zip(maps, (jf, tf)):
            frame.point_ids = point_ids.copy()
            kf = m.add_keyframe(frame, Tcw_est.astype(np.float32))
            pids = m.add_stereo_points_batch(frame, kf, new, cam)
            old = point_ids[point_ids >= 0]
            m.compute_distinctive_descriptors_batch(old)
            m.update_normals_batch(old)
            m.update_connections(kf)
        for slot, pid in zip(new, pids):
            w = seen[slot]
            if w not in made or k - made[w][1] > N_KF // 2:
                made.setdefault(w, (int(pid), k))
        frames[0].append(seen)
    # the loop constraint: keyframe N_KF - 1 at its true pose in keyframe
    # 0's (drift-free) world; every second of its features that see points
    # keyframe 0's group made matched to those points
    kf = N_KF - 1
    m = maps[1]
    group = [0] + m.covisible_keyframes(0)
    ids = np.unique(np.concatenate([m.kf_point[g] for g in group]))
    loop_pts = [int(p) for p in ids[m.valid_mask(ids)]]
    loop_set = set(loop_pts)
    shared = [(slot, made[w][0]) for slot, w in enumerate(frames[0][kf])
              if w in made and made[w][0] in loop_set and int(m.kf_point[kf][slot]) != made[w][0]]
    matched = dict(shared[::2])  # SearchAndFuse finds the rest
    constraint = dict(_Scw=(gt[kf][:3, :3].copy(), gt[kf][:3, 3].copy(), 1.0), _matched_kf=0,
                      _matched_points=matched, _loop_points=loop_pts)
    return cfg, maps, constraint, gt


def _closers(cfg, maps):
    jcfg = slam_config(SyntheticWorld(n_points=10, seed=1, baseline=0.2), jax_config)
    jfront, tfront = JaxFrontend(jcfg), Frontend(cfg, "cpu")
    (cd, ci, nw, ww, k, depth), _ = cases.ragged_tree(np.random.default_rng(0))
    jvoc = jax_bow.Vocabulary(jnp.asarray(cd), jnp.asarray(ci), jnp.asarray(nw), jnp.asarray(ww), k, depth)
    tvoc = convert.vocabulary_to_torch(jvoc, "cpu")
    jl = JaxCloser(jcfg, jfront, maps[0], JaxRelocalizer(jcfg, jfront, maps[0], jvoc))
    tl = LoopCloser(cfg, tfront, maps[1], Relocalizer(cfg, tfront, maps[1], tvoc))
    return jl, tl


def _observations_of(m):
    return sorted((int(p), k, i) for p in m.pt_ids() for k, i in m.pt_obs[int(p)].items())


@pytest.fixture(scope="module")
def correction():
    cfg, maps, constraint, gt = _build_ring_maps()
    closers = _closers(cfg, maps)
    kf = N_KF - 1
    out = []
    for closer in closers:
        for name, value in constraint.items():
            setattr(closer, name, value)
        with closer.lock:
            pg_args, fuse_args = closer._correct_loop_locked(kf)
        propagated = {k: closer.map.kf_pose[k].copy() for k in fuse_args[0]}
        obs_before = _observations_of(closer.map)
        links = closer._search_and_fuse(kf, *fuse_args)
        fused = sorted(set(_observations_of(closer.map)) - set(obs_before))
        closer._optimize_essential_graph(kf, *pg_args, links)
        poses = {k: closer.map.kf_pose[k].copy() for k in sorted(closer.map.kf_valid)}
        out.append(dict(group=fuse_args[0], propagated=propagated, links=links, fused=fused,
                        replaced=dict(closer.map.pt_replaced), poses=poses))
    return dict(jax=out[0], port=out[1], constraint=constraint, gt=gt)


def test_loop_correction_matches_jax(correction):
    j, t = correction["jax"], correction["port"]
    assert len(correction["constraint"]["_matched_points"]) > 20
    assert j["group"] == t["group"] and len(t["group"]) >= 3
    for k in j["group"]:
        np.testing.assert_allclose(t["propagated"][k], j["propagated"][k], atol=1e-5)
    # SearchAndFuse: the same pairs fused, the same points replaced, the
    # same new loop connections
    assert len(t["fused"]) > 20
    assert t["fused"] == j["fused"]
    assert t["replaced"] == j["replaced"]
    assert t["links"] == j["links"] and t["links"]
    # the essential graph: every keyframe within 1e-3 m and 1e-3 rad
    assert sorted(t["poses"]) == sorted(j["poses"])
    for k in j["poses"]:
        Tj, Tt = j["poses"][k].astype(np.float64), t["poses"][k].astype(np.float64)
        cj, ct = -Tj[:3, :3].T @ Tj[:3, 3], -Tt[:3, :3].T @ Tt[:3, 3]
        assert np.linalg.norm(cj - ct) < 1e-3, k
        assert rot_err(Tj[:3, :3], Tt[:3, :3]) < 1e-3, k
    # the loop pulled the drifted end towards the truth
    gt = correction["gt"]
    end = N_KF - 2
    c_gt = -gt[end][:3, :3].T @ gt[end][:3, 3]
    c_before = -(gt[end] @ np.linalg.inv(_drift(end)))[:3, :3].T @ (gt[end] @ np.linalg.inv(_drift(end)))[:3, 3]
    Tt = t["poses"][end].astype(np.float64)
    assert np.linalg.norm(-Tt[:3, :3].T @ Tt[:3, 3] - c_gt) < 0.5 * np.linalg.norm(c_before - c_gt)


# ---------------------------------------------------------------------------
# the port twin of tests/test_loop_closing.py (slow: never in Tier-1)
# ---------------------------------------------------------------------------


@pytest.mark.slow
def test_circuit_closes_loop():
    from orbslam2_tpu.config import CameraConfig, OrbConfig, SlamConfig
    from orbslam2_tpu.vocab import train
    from orbslam2_tpu_torch.evaluation.ate import ate_rmse
    from orbslam2_tpu_torch.slam.local_mapping import LocalMapper
    from orbslam2_tpu_torch.slam.tracking import Tracker, TrackingState

    world = SyntheticWorld(n_points=2000, seed=21, baseline=0.2, vertical_extent=6.0,
                           cylinder_radius=11.0, near_fraction=0.15)
    cam = dict(fx=world.fx, fy=world.fy, cx=world.cx, cy=world.cy, bf=world.bf, width=world.width,
               height=world.height, fps=20.0)
    # tests/test_loop_closing.py's vocabulary, trained by the JAX package
    jf = JaxFrontend(SlamConfig(camera=CameraConfig(**cam), orb=OrbConfig(n_features=1200)))
    descs, docs = [], []
    for d, T in enumerate(world.trajectory_circuit(8)):
        imL, _ = world.render_stereo(T)
        f = jf.process(imL, imL)
        dd = np.asarray(f.desc)[np.asarray(f.valid)][:400]
        descs.append(np.ascontiguousarray(dd).view(np.uint8))
        docs.append(np.full(len(dd), d))
    voc = train.train_vocabulary(np.concatenate(descs), k=8, depth=3, doc_ids=np.concatenate(docs))

    cfg = torch_config.SlamConfig(camera=torch_config.CameraConfig(**cam),
                                  orb=torch_config.OrbConfig(n_features=1200))
    frontend = Frontend(cfg, "cpu")
    slam_map = SlamMap(cfg.orb.n_features)
    tracker = Tracker(cfg, frontend, slam_map)
    mapper = LocalMapper(cfg, frontend, slam_map)
    tracker.local_mapper = mapper
    reloc = Relocalizer(cfg, frontend, slam_map, convert.vocabulary_to_torch(voc, "cpu"))
    tracker.relocalizer = reloc
    closer = LoopCloser(cfg, frontend, slam_map, reloc, local_mapper=mapper)
    mapper.on_processed = closer.insert_keyframe

    poses_gt = world.trajectory_circuit(150)
    est = [tracker.track(*world.render_stereo(T), i / 20.0) for i, T in enumerate(poses_gt)]
    assert tracker.state == TrackingState.OK
    assert all(e is not None for e in est)
    assert closer.n_loops_closed >= 1, "no loop closure fired on the circuit"
    assert sum(len(v) for v in slam_map.loop_edges.values()) >= 2
    c = lambda T: -T[:3, :3].T.astype(np.float64) @ T[:3, 3]  # noqa: E731
    rmse = ate_rmse(np.stack([c(e) for e in est]), np.stack([c(g) for g in poses_gt]))
    assert rmse < 0.30, f"ATE RMSE {rmse:.3f} m"
