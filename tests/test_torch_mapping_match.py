"""The local mapper's matchers and triangulation against the JAX package's,
on the CPU.

Inputs: ORB keypoints the port extracts from rendered SyntheticWorld
frames (`_torch_parity.matcher_pair`: frame 2's left and right eye), the
same numpy arrays handed to both packages.
  * `epipolar_match`: frame 2's left eye (keyframe 1) against its right
    eye (keyframe 2), with the stereo rig's fundamental matrix and an
    epipole inside the image, random free and stereo flags;
  * `fuse_match`: projected points made from left-eye keypoints, plus rows
    placed exactly on the window's edge and on the chi2 test's edge (7.8
    for a keypoint with a right u, 5.99 without), and one float32 ulp
    beyond (the chi2 disc lies inside the window, so no row on the
    window's edge passes the chi2 test: those rows match nothing in
    either package);
  * the triangulation: frame 10's left eye as keyframe 1 against frames 4
    and 16 as neighbours, at their true poses, through
    `LocalMapper._epipolar_batch` and the JAX mapper's
    `_jit_epipolar_batch`.

Stated tolerances: the matchers' indices equal on >= 99% of rows (the
boundary rows all equal); the triangulation's m12 and valid equal on
>= 99% of rows, and where both are valid x3d within 1e-3 m plus 1e-3 of
the point's distance from keyframe 1. Both packages solve the 3x3 normal
equations of the DLT rows in float32, which loses about four digits at
this parallax: on this case each is up to 5.5e-4 of the distance (14 mm
at 15 m) from a float64 evaluation of the same expressions, for 32 of
the 361 points more than 1e-3 m.
"""

import numpy as np
import pytest
import torch
from _torch_parity import (both, desc_both, flip_bits, jax_and_torch, matcher_pair, np_of, on_boundary,
                           slam_config)

from orbslam2_tpu import config as jax_config
from orbslam2_tpu.ops import matchers as jmatch
from orbslam2_tpu.slam.frontend import Frontend as JaxFrontend
from orbslam2_tpu.slam.local_mapping import LocalMapper as JaxMapper
from orbslam2_tpu.slam.map import SlamMap as JaxMap
from orbslam2_tpu_torch import config as torch_config
from orbslam2_tpu_torch.ops import matchers as tmatch
from orbslam2_tpu_torch.slam.frontend import Frontend
from orbslam2_tpu_torch.slam.local_mapping import LocalMapper
from orbslam2_tpu_torch.slam.map import SlamMap

SF = (1.2 ** np.arange(8)).astype(np.float32)
SIG2 = (1.44 ** np.arange(8)).astype(np.float32)
INV_SIG2 = (1.0 / 1.44 ** np.arange(8)).astype(np.float32)


@pytest.fixture(scope="module")
def pair():
    return matcher_pair()


def _fundamental(world, T1, T2):
    T12 = T1.astype(np.float64) @ np.linalg.inv(T2.astype(np.float64))
    t = T12[:3, 3]
    tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]])
    Kinv = np.linalg.inv(np.array([[world.fx, 0, world.cx], [0, world.fy, world.cy], [0, 0, 1]]))
    return (Kinv.T @ tx @ T12[:3, :3] @ Kinv).astype(np.float32)


def test_epipolar_match(pair):
    world, (left, right) = pair
    rng = np.random.default_rng(31)
    T2 = np.eye(4)
    T2[0, 3] = -world.baseline
    F12 = _fundamental(world, np.eye(4), T2)
    n = len(left["valid"])
    free1 = left["valid"] & (rng.uniform(size=n) < 0.8)
    free2 = right["valid"] & (rng.uniform(size=n) < 0.8)
    stereo1, stereo2 = rng.uniform(size=n) < 0.5, rng.uniform(size=n) < 0.5
    ep = np.array([world.cx, world.cy], np.float32)
    args = (left["uv"], left["desc"], free1, left["angle"], stereo1, right["uv"], right["oct"], right["desc"],
            free2, right["angle"], stereo2, F12, ep, SF, SIG2)
    (mj, dj), (mt, dt) = jax_and_torch(jmatch.epipolar_match, tmatch.epipolar_match, args, (1, 7))
    mj, mt = np_of(mj), np_of(mt)
    assert (mj == mt).mean() >= 0.99, (mj == mt).mean()
    assert (np_of(dj) == np_of(dt)).mean() >= 0.99
    assert (mt >= 0).sum() > 100
    # kf2-side uniqueness: a column is claimed only at its best distance
    hit = mt >= 0
    d = np_of(dt)[hit]
    for col in np.unique(mt[hit]):
        assert (d[mt[hit] == col] == d[mt[hit] == col].min()).all()


def _chi2_edge(rng, c, base, other2, isig_th, n):
    """n coordinates x near `base` with fl((fl(c - x)^2 + other2)) straddling
    th: the last passing float32 (first half) or the first failing one."""
    f32 = np.float32
    out = []
    for j in range(n):
        x = f32(base[j])
        e2 = lambda x: f32(f32(f32(c[j] - x) * f32(c[j] - x)) + f32(other2[j]))  # noqa: E731
        step = f32(-np.inf) if c[j] > x else f32(np.inf)  # away from c raises e2
        while e2(x) <= isig_th:
            x = np.nextafter(x, step)
        while e2(x) > isig_th:
            x = np.nextafter(x, -step)
        out.append(x if j < n // 2 else np.nextafter(x, step))
    return np.array(out, f32)


def test_fuse_match(pair):
    world, (kf, right) = pair
    rng = np.random.default_rng(41)
    f32 = np.float32
    sm = tmatch.stereo_match(*[torch.from_numpy(a) for a in (
        kf["uv"], kf["oct"], kf["desc"].view(np.int32), kf["valid"], right["uv"], right["oct"],
        right["desc"].view(np.int32), right["valid"], SF)], world.bf, world.baseline)
    ur_kp = sm.u_right.numpy()
    P, k = 600, 40
    pick = rng.choice(np.nonzero(kf["valid"])[0], P, replace=False)
    uv = (kf["uv"][pick] + rng.normal(0, 1.5, (P, 2))).astype(f32)
    level = np.clip(kf["oct"][pick] + rng.integers(0, 2, P), 0, 7).astype(np.int32)
    ur_pt = np.where(ur_kp[pick] >= 0, ur_kp[pick], uv[:, 0] - 10.0).astype(f32)
    ur_pt = (ur_pt + rng.normal(0, 1.0, P)).astype(f32)
    desc = flip_bits(rng, kf["desc"][pick])
    # level-0 rows (radius 3.0, isig 1) at octave-0 keypoints, matched by
    # descriptor: on the window's edge in v (rows 0..k), on the chi2 edge
    # of a stereo keypoint through the right u (k..2k: du = 0, dv = 1) and
    # of a mono keypoint through v (2k..3k: du = 0)
    oct0 = kf["valid"] & (kf["oct"] == 0)
    stereo0, mono0 = np.nonzero(oct0 & (ur_kp >= 0))[0], np.nonzero(oct0 & (ur_kp < 0))[0]
    cols, v = on_boundary(rng, kf["uv"][:, 1], np.nonzero(oct0)[0], 3.0, k)
    uv[:k] = np.stack([kf["uv"][cols, 0], v], axis=1)
    ur_pt[:k] = np.where(ur_kp[cols] >= 0, ur_kp[cols], 0.0)
    cs = rng.choice(stereo0, k, replace=False)
    uv[k:2 * k] = np.stack([kf["uv"][cs, 0], kf["uv"][cs, 1] - f32(1.0)], axis=1)
    ur_pt[k:2 * k] = _chi2_edge(rng, ur_kp[cs], ur_kp[cs] + f32(2.6), np.ones(k, f32), f32(7.8), k)
    cm = rng.choice(mono0, k, replace=False)
    vm = _chi2_edge(rng, kf["uv"][cm, 1], kf["uv"][cm, 1] - f32(2.4), np.zeros(k, f32), f32(5.99), k)
    uv[2 * k:3 * k] = np.stack([kf["uv"][cm, 0], vm], axis=1)
    edge_cols = np.concatenate([cols, cs, cm])
    desc[:3 * k] = kf["desc"][edge_cols]
    level[:3 * k] = 0
    valid = rng.uniform(size=P) < 0.9
    valid[:3 * k] = True
    args = (kf["uv"], kf["oct"], ur_kp, kf["desc"], kf["valid"], uv, ur_pt, level, desc, valid, SF, INV_SIG2)
    (ij, dj), (it, dt) = jax_and_torch(jmatch.fuse_match, tmatch.fuse_match, args, (3, 8))
    ij, it = np_of(ij), np_of(it)
    assert (ij == it).mean() >= 0.99, (ij == it).mean()
    np.testing.assert_array_equal(it[:3 * k], ij[:3 * k])
    np.testing.assert_array_equal(np_of(dt)[:3 * k], np_of(dj)[:3 * k])
    # the boundary rows land on both sides: half at their column, half not
    for lo in (k, 2 * k):
        on = it[lo:lo + k] == edge_cols[lo:lo + k]
        assert on[: k // 2].all() and not on[k // 2:].any(), lo
    assert (it >= 0).sum() > 150


def triangulation_case():
    """Keyframe 1 (frame 10) and two neighbours (frames 4 and 16) of the
    40-frame sequence at their true poses, the port's features on the CPU:
    (arguments of the JAX mapper's `_jit_epipolar_batch`, the same for
    the port's `_epipolar_batch`, the JAX mapper, the port's mapper)."""
    from orbslam2_tpu_torch.datasets.synthetic import SyntheticWorld

    world = SyntheticWorld(n_points=900, seed=7, baseline=0.2)
    poses = world.trajectory(17, step=0.06)
    tcfg = slam_config(world, torch_config)
    tfront = Frontend(tcfg, "cpu")
    feats, Ts = [], []
    for i in (10, 4, 16):
        imL, imR = world.render_stereo(poses[i])
        f = tfront.process(np.clip(np.rint(imL), 0, 255), np.clip(np.rint(imR), 0, 255))
        feats.append({k: np_of(v) for k, v in f._asdict().items()})
        feats[-1]["desc"] = feats[-1]["desc"].view(np.uint32)
        Ts.append(np.asarray(poses[i], np.float64))
    jcfg = slam_config(world, jax_config)
    jmapper = JaxMapper(jcfg, JaxFrontend(jcfg), JaxMap(jcfg.orb.n_features))
    tmapper = LocalMapper(tcfg, tfront, SlamMap(tcfg.orb.n_features))

    rng = np.random.default_rng(5)
    f1, nbrs = feats[0], feats[1:]
    T1 = Ts[0]
    O1 = np.linalg.inv(T1)[:3, 3]
    free1 = f1["valid"] & (rng.uniform(size=len(f1["valid"])) < 0.7)
    per_nbr = []
    for f2, T2 in zip(nbrs, Ts[1:]):
        C2 = T2[:3, :3] @ O1 + T2[:3, 3]
        per_nbr.append(dict(
            free2=f2["valid"] & (rng.uniform(size=len(f2["valid"])) < 0.7), stereo2=f2["u_right"] >= 0,
            F=_fundamental(world, T1, T2),
            ep=np.array([world.fx * C2[0] / C2[2] + world.cx, world.fy * C2[1] / C2[2] + world.cy], np.float32),
            T2=T2.astype(np.float32), Twc2=np.linalg.inv(T2).astype(np.float32),
            O2=np.linalg.inv(T2)[:3, 3].astype(np.float32)))
    kf1 = [f1["uv"], f1["desc"], free1, f1["angle"], f1["u_right"] >= 0, f1["depth"], f1["u_right"], f1["octave"]]
    nb = [[f2[k] for f2 in nbrs] for k in ("uv", "octave", "desc")] + [[p["free2"] for p in per_nbr]] + [
        [f2["angle"] for f2 in nbrs], [p["stereo2"] for p in per_nbr], [f2["depth"] for f2 in nbrs],
        [f2["u_right"] for f2 in nbrs], [p["F"] for p in per_nbr], [p["ep"] for p in per_nbr]]
    poses = [T1.astype(np.float32), [p["T2"] for p in per_nbr], np.linalg.inv(T1).astype(np.float32),
             [p["Twc2"] for p in per_nbr], O1.astype(np.float32), [p["O2"] for p in per_nbr]]

    def jx(a, i=None):
        return desc_both(a)[0] if i == "desc" else both(a)[0]

    def tt(a, i=None):
        return desc_both(a)[1] if i == "desc" else both(a)[1]

    jargs = [jx(a, "desc" if i == 1 else None) for i, a in enumerate(kf1)]
    jargs += [tuple(jx(a, "desc" if i == 2 else None) for a in col) for i, col in enumerate(nb)]
    jargs += [jx(poses[0]), tuple(map(jx, poses[1])), jx(poses[2]), tuple(map(jx, poses[3])), jx(poses[4]),
              tuple(map(jx, poses[5]))]
    targs = [tt(a, "desc" if i == 1 else None) for i, a in enumerate(kf1)]
    targs += [torch.stack([tt(a, "desc" if i == 2 else None) for a in col]) for i, col in enumerate(nb)]
    targs += [tt(poses[0]), torch.stack(list(map(tt, poses[1]))), tt(poses[2]), torch.stack(list(map(tt, poses[3]))),
              tt(poses[4]), torch.stack(list(map(tt, poses[5])))]
    return jargs, targs, jmapper, tmapper


@pytest.fixture(scope="module")
def triangulation():
    return triangulation_case()


def test_triangulation_matches_jax(triangulation):
    jargs, targs, jmapper, tmapper = triangulation
    mj, xj, vj = (np_of(a) for a in jmapper._jit_epipolar_batch(*jargs))
    mt, xt, vt = (np_of(a) for a in tmapper._epipolar_batch(*targs))
    assert mt.shape == mj.shape == (2, targs[0].shape[0])
    assert (mj == mt).mean() >= 0.99, (mj == mt).mean()
    assert (vj == vt).mean() >= 0.99, (vj == vt).mean()
    both_valid = vj & vt
    assert both_valid.sum() > 50
    gap = np.linalg.norm(xt[both_valid] - xj[both_valid], axis=-1)
    dist = np.linalg.norm(xj[both_valid] - np_of(targs[22]), axis=-1)
    assert (gap <= 1e-3 + 1e-3 * dist).all(), (gap / dist).max()
