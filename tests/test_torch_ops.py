"""Parity of the PyTorch port's geometry and ops against the JAX package.

Stated tolerances: se3/camera <= 1e-5 (absolute plus 1e-5 relative: the
float32 libm calls differ between the frameworks, and (1 - cos t)/t^2
amplifies that near small angles); FAST score + NMS exact on the
same float image; Hamming, masked best/second best exact (all-masked rows
and ties included); the ORB constant tables exact; pose_optimize within
1e-3 rad / 1e-3 m with inlier masks equal on >= 99% of edges.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import both, desc_both, np_of, rot_err

from orbslam2_tpu.geometry import camera as jcam
from orbslam2_tpu.geometry import se3 as jse3
from orbslam2_tpu.ops import fast as jfast
from orbslam2_tpu.ops import hamming as jham
from orbslam2_tpu.ops import matchers as jmatch
from orbslam2_tpu.ops import orb as jorb
from orbslam2_tpu.ops import pose_opt as jpose
from orbslam2_tpu_torch import convert
from orbslam2_tpu_torch.geometry import camera as tcam
from orbslam2_tpu_torch.geometry import se3 as tse3
from orbslam2_tpu_torch.ops import fast as tfast
from orbslam2_tpu_torch.ops import hamming as tham
from orbslam2_tpu_torch.ops import matchers as tmatch
from orbslam2_tpu_torch.ops import pose_opt as tpose

TOL_GEOM = 1e-5


def _xi(rng, n, rot=0.5, trans=2.0):
    return np.concatenate(
        [rng.uniform(-rot, rot, (n, 3)), rng.uniform(-trans, trans, (n, 3))], axis=1
    ).astype(np.float32)


# ---------------------------------------------------------------------------
# se3 / camera
# ---------------------------------------------------------------------------


class TestSE3:
    @pytest.mark.parametrize("scale", [1e-6, 1e-2, 0.5, 3.0])
    def test_exp_log(self, scale):
        rng = np.random.default_rng(1)
        xi = _xi(rng, 64, rot=scale, trans=2.0)
        jx, tx = both(xi)
        Tj, Tt = jse3.exp(jx), tse3.exp(tx)
        np.testing.assert_allclose(np_of(Tt), np_of(Tj), rtol=TOL_GEOM, atol=TOL_GEOM)
        np.testing.assert_allclose(np_of(tse3.log(Tt)), np_of(jse3.log(Tj)), rtol=TOL_GEOM, atol=TOL_GEOM)

    def test_transform_hat_retract_inverse(self):
        rng = np.random.default_rng(2)
        T = np.asarray(jse3.exp(jnp.asarray(_xi(rng, 16))))
        p = rng.uniform(-5, 5, (16, 3)).astype(np.float32)
        dx = _xi(rng, 16, rot=0.05, trans=0.1)
        (jT, tT), (jp, tp), (jd, td) = both(T), both(p), both(dx)
        pairs = [
            (tse3.transform(tT, tp), jse3.transform(jT, jp)),
            (tse3.hat(tp), jse3.hat(jp)),
            (tse3.retract(tT, td), jse3.retract(jT, jd)),
            (tse3.inverse(tT), jse3.inverse(jT)),
        ]
        for t, j in pairs:
            np.testing.assert_allclose(np_of(t), np_of(j), rtol=TOL_GEOM, atol=TOL_GEOM)

    def test_quaternion(self):
        rng = np.random.default_rng(3)
        xi = _xi(rng, 64, rot=3.0)
        xi[:4, :3] = [[np.pi, 0, 0], [0, np.pi, 0], [0, 0, np.pi], [0, 0, 0]]
        R = np.asarray(jse3.exp(jnp.asarray(xi)))[:, :3, :3]
        jR, tR = both(R)
        qj, qt = np_of(jse3.to_quaternion(jR)), np_of(tse3.to_quaternion(tR))
        sign = np.sign(np.sum(qj * qt, axis=-1, keepdims=True))
        np.testing.assert_allclose(qt * sign, qj, atol=TOL_GEOM)


class TestCamera:
    ARGS = (458.654, 457.296, 367.215, 248.375, 47.9, 752, 480)

    def test_project_unproject(self):
        rng = np.random.default_rng(4)
        pc = rng.uniform([-5, -3, 0.5], [5, 3, 30], (200, 3)).astype(np.float32)
        jc, tc = jcam.make_camera(*self.ARGS), tcam.make_camera(*self.ARGS)
        jp, tp = both(pc)
        np.testing.assert_allclose(
            np_of(tcam.project_stereo(tc, tp)), np_of(jcam.project_stereo(jc, jp)),
            rtol=TOL_GEOM, atol=TOL_GEOM,
        )
        uvd = np.asarray(jcam.project(jc, jp))
        ju, tu = both(uvd[:, 0])
        jv, tv = both(uvd[:, 1])
        jz, tz = both(pc[:, 2])
        np.testing.assert_allclose(
            np_of(tcam.unproject_stereo(tc, tu, tv, tz)),
            np_of(jcam.unproject_stereo(jc, ju, jv, jz)), rtol=TOL_GEOM, atol=TOL_GEOM,
        )

    def test_in_frustum(self):
        rng = np.random.default_rng(5)
        pw = rng.uniform([-10, -5, -2], [10, 5, 30], (300, 3)).astype(np.float32)
        normal = rng.normal(size=(300, 3)).astype(np.float32)
        normal /= np.linalg.norm(normal, axis=1, keepdims=True)
        T = np.asarray(jse3.exp(jnp.asarray(_xi(rng, 1, rot=0.1, trans=0.5)[0])))
        args = [both(a) for a in (T, pw, normal, np.full(300, 1.0, np.float32),
                                  np.full(300, 25.0, np.float32))]
        jc, tc = jcam.make_camera(*self.ARGS), tcam.make_camera(*self.ARGS)
        out_j = jcam.is_in_frustum(jc, *[a[0] for a in args])
        out_t = tcam.is_in_frustum(tc, *[a[1] for a in args])
        np.testing.assert_array_equal(np_of(out_t[0]), np_of(out_j[0]))
        for t, j in zip(out_t[1:], out_j[1:]):
            np.testing.assert_allclose(np_of(t), np_of(j), rtol=TOL_GEOM, atol=TOL_GEOM)


# ---------------------------------------------------------------------------
# FAST + NMS (plain version of kernel K2): exact
# ---------------------------------------------------------------------------


def _test_image(seed, h=72, w=104, integer=True):
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 255, (2, h // 8 + 1, w // 8 + 1))
    img = np.kron(img, np.ones((8, 8)))[:, :h, :w] + rng.normal(0, 12, (2, h, w))
    img = np.clip(img, 0, 255)
    return (np.rint(img) if integer else img).astype(np.float32)


class TestFast:
    @pytest.mark.parametrize("integer", [True, False])
    def test_score_and_nms_exact(self, integer):
        jimg, timg = both(_test_image(6, integer=integer))
        sj = jfast.fast_score(jimg)
        st = tfast.fast_score(timg)
        np.testing.assert_array_equal(np_of(st), np_of(sj))
        np.testing.assert_array_equal(np_of(tfast.nms3(st)), np_of(jfast.nms3(sj)))
        masked_j = np_of(jnp.where(jfast.nms3(sj), sj, 0.0))
        np.testing.assert_array_equal(np_of(tfast.fast_nms(timg)), masked_j)
        assert (masked_j > 0).sum() > 20

    def test_circle_matches(self):
        assert convert.CIRCLE == jfast.CIRCLE


# ---------------------------------------------------------------------------
# Hamming (plain version of kernel K3): exact
# ---------------------------------------------------------------------------


def _descs(rng, n, ties=False):
    if ties:  # few distinct words -> many equal distances
        return rng.choice(np.array([0, 1, 3, 0xFFFFFFFF, 0x80000000], np.uint32), (n, 8))
    return rng.integers(0, 2**32, (n, 8), dtype=np.uint64).astype(np.uint32)


class TestHamming:
    @pytest.mark.parametrize("ties", [False, True])
    def test_matrix_and_best2_exact(self, ties):
        rng = np.random.default_rng(7)
        A, B = _descs(rng, 40, ties), _descs(rng, 57, ties)
        mask = rng.uniform(size=(40, 57)) < 0.3
        mask[:5] = False  # all-masked rows
        mask[5, :] = False
        mask[5, 9] = True  # a single candidate
        (jA, tA), (jB, tB) = desc_both(A), desc_both(B)
        jm, tm = both(mask)

        dj = jham.hamming_matrix(jA, jB)
        np.testing.assert_array_equal(np_of(tham.hamming_matrix(tA, tB)), np_of(dj))
        ref = np.unpackbits((A[:, None] ^ B[None]).view(np.uint8), axis=-1).sum(-1)
        np.testing.assert_array_equal(np_of(dj), ref)

        i1, d1 = jham.masked_argmin(dj, jm)
        k1, b1, s1 = jham.masked_two_smallest(dj, jm)
        # the second-index pass of search_by_projection_points
        choice = jax.nn.one_hot(k1, dj.shape[1], dtype=bool)
        i2 = jnp.argmin(jnp.where(jm & ~choice, dj, jham.MAX_DIST), axis=-1)
        out = [np_of(x) for x in tham.best2(tA, tB, tm)]
        np.testing.assert_array_equal(out[0], np_of(i1))
        np.testing.assert_array_equal(out[1], np_of(d1))
        np.testing.assert_array_equal(out[0], np_of(k1))
        np.testing.assert_array_equal(out[1], np_of(b1))
        np.testing.assert_array_equal(out[2], np_of(i2))
        np.testing.assert_array_equal(out[3], np_of(s1))
        assert (out[1][:5] == 256).all() and (out[0][:5] == 0).all()
        assert (out[3][5] == 256) and (out[2][5] == 0)

        tdist = tham.hamming_matrix(tA, tB)
        for fn_t, fn_j in ((tham.masked_argmin, jham.masked_argmin),
                           (tham.masked_two_smallest, jham.masked_two_smallest)):
            for t, j in zip(fn_t(tdist, tm), fn_j(dj, jm)):
                np.testing.assert_array_equal(np_of(t), np_of(j))

    def test_popcount_sign_bit(self):
        words = np.array([0, 1, 0x80000000, 0xFFFFFFFF, 0x7FFFFFFF, 0xAAAAAAAA], np.uint32)
        t = torch.from_numpy(words.view(np.int32).copy())
        want = [bin(int(w)).count("1") for w in words]
        assert tham.popcount32(t).tolist() == want


# ---------------------------------------------------------------------------
# matchers' building blocks
# ---------------------------------------------------------------------------


class TestMatcherBlocks:
    def test_resolve_collisions(self):
        rng = np.random.default_rng(8)
        idx = rng.integers(0, 30, 200).astype(np.int32)
        d = rng.integers(0, 60, 200).astype(np.int32)
        d[rng.uniform(size=200) < 0.3] = jham.MAX_DIST
        (ji, ti), (jd, td) = both(idx), both(d)
        for t, j in zip(tmatch._resolve_collisions(ti, td, 40), jmatch._resolve_collisions(ji, jd, 40)):
            np.testing.assert_array_equal(np_of(t), np_of(j))

    def test_rotation_consistency(self):
        rng = np.random.default_rng(9)
        a = rng.uniform(-np.pi, np.pi, 300).astype(np.float32)
        b = (a - 0.3 + rng.normal(0, 0.05, 300)).astype(np.float32)
        b[:60] = rng.uniform(-np.pi, np.pi, 60)
        valid = rng.uniform(size=300) < 0.9
        args = [both(x) for x in (a, b, valid)]
        t = tmatch.rotation_consistency_mask(*[x[1] for x in args])
        j = jmatch.rotation_consistency_mask(*[x[0] for x in args])
        np.testing.assert_array_equal(np_of(t), np_of(j))

    def test_search_by_projection_points(self):
        rng = np.random.default_rng(10)
        N, P = 300, 256
        uv = rng.uniform([0, 0], [752, 480], (N, 2)).astype(np.float32)
        octv = rng.integers(0, 8, N).astype(np.int32)
        ur = np.where(rng.uniform(size=N) < 0.7, uv[:, 0] - 10.0, -1.0).astype(np.float32)
        desc = _descs(rng, N)
        pick = rng.integers(0, N, P)
        uv_pt = (uv[pick] + rng.normal(0, 2.0, (P, 2))).astype(np.float32)
        ur_pt = (uv_pt[:, 0] - 10.0).astype(np.float32)
        lvl = np.clip(octv[pick] + rng.integers(0, 2, P), 0, 7).astype(np.int32)
        vcos = rng.uniform(0.9, 1.0, P).astype(np.float32)
        dpt = desc[pick].copy()
        flips = rng.integers(0, 32, (P, 8)).astype(np.uint32)
        dpt ^= (np.uint32(1) << flips) * (rng.uniform(size=(P, 8)) < 0.5)
        vcur = rng.uniform(size=N) < 0.9
        vpt = rng.uniform(size=P) < 0.9
        sf = (1.2 ** np.arange(8)).astype(np.float32)
        args_np = (uv, octv, ur, desc, vcur, uv_pt, ur_pt, lvl, vcos, dpt, vpt, sf)
        jargs, targs = [], []
        for i, a in enumerate(args_np):
            j, t = desc_both(a) if i in (3, 9) else both(a)
            jargs.append(j)
            targs.append(t)
        pj, dj = jmatch.search_by_projection_points(*jargs, 1.0)
        pt, dt = tmatch.search_by_projection_points(*targs, 1.0)
        np.testing.assert_array_equal(np_of(pt), np_of(pj))
        np.testing.assert_array_equal(np_of(dt), np_of(dj))
        assert (np_of(pt) >= 0).sum() > 50


# ---------------------------------------------------------------------------
# ORB constant tables (convert.py): exact
# ---------------------------------------------------------------------------


def test_orb_tables_equal_jax():
    np.testing.assert_array_equal(convert.PATTERN, jorb._PATTERN)
    np.testing.assert_array_equal(convert.IC_MASK, jorb._IC_MASK)
    np.testing.assert_array_equal(convert.W2, jorb._W2)
    np.testing.assert_array_equal(convert.G7, jorb._G7)
    np.testing.assert_array_equal(convert.BLUR_BAND, jorb._BLUR_BAND)
    np.testing.assert_array_equal(convert.BIN_FLAT, jorb._BIN_FLAT)
    assert convert.BIN_FLAT.min() >= 0 and convert.BIN_FLAT.max() < 42 * 42


# ---------------------------------------------------------------------------
# pose optimization
# ---------------------------------------------------------------------------

CAM_ARGS = (458.0, 457.0, 376.0, 240.0, 47.9, 752, 480)


def _pose_problem(seed, n=300, outlier_frac=0.25):
    rng = np.random.default_rng(seed)
    cam = jcam.make_camera(*CAM_ARGS)
    pw = rng.uniform([-5, -3, 4], [5, 3, 25], (n, 3)).astype(np.float32)
    T_true = jse3.exp(jnp.asarray([0.02, -0.03, 0.01, 0.3, -0.2, 0.15], jnp.float32))
    obs = np.array(jcam.project_stereo(cam, jse3.transform(T_true, jnp.asarray(pw))))
    obs[:, :2] += rng.normal(0, 0.3, (n, 2))
    is_stereo = rng.uniform(size=n) < 0.8
    out = rng.choice(n, int(outlier_frac * n), replace=False)
    obs[out, :2] += rng.uniform(15, 60, (len(out), 2)) * rng.choice([-1, 1], (len(out), 2))
    inv_sigma2 = (1.0 / 1.44 ** rng.integers(0, 3, n)).astype(np.float32)
    T0 = np.asarray(jse3.retract(T_true, jnp.asarray([0.01, 0.02, -0.01, 0.08, -0.06, 0.05], jnp.float32)))
    return T0, pw, obs.astype(np.float32), inv_sigma2, is_stereo, np.ones(n, bool)


@pytest.fixture(scope="module")
def jit_pose():
    cam = jcam.make_camera(*CAM_ARGS)
    return jax.jit(lambda *a: jpose.pose_optimize(*a, cam))


class TestPoseOptimize:
    @pytest.mark.parametrize("case", ["outliers", "all_invalid", "half_invalid"])
    def test_matches_jax(self, case, jit_pose):
        T0, pw, obs, isig, ster, valid = _pose_problem(11)
        if case == "all_invalid":
            valid[:] = False
        elif case == "half_invalid":
            valid[150:] = False
        args = [both(a) for a in (T0, pw, obs, isig, ster, valid)]
        rj = jit_pose(*[a[0] for a in args])
        rt = tpose.pose_optimize(*[a[1] for a in args], tcam.make_camera(*CAM_ARGS))
        Tj, Tt = np_of(rj.Tcw), np_of(rt.Tcw)
        assert np.isfinite(Tt).all()
        assert rot_err(Tt[:3, :3], Tj[:3, :3]) <= 1e-3
        assert np.abs(Tt[:3, 3] - Tj[:3, 3]).max() <= 1e-3
        agree = (np_of(rt.inlier) == np_of(rj.inlier)).mean()
        assert agree >= 0.99, agree
        if case == "all_invalid":
            np.testing.assert_array_equal(Tt, T0)
            assert int(rt.n_inliers) == 0

    def test_solve6_clamp(self):
        x = tpose._solve6(torch.zeros(6, 6), torch.zeros(6))
        assert torch.equal(x, torch.zeros(6))
        A = torch.from_numpy(np.diag([4.0, 9.0, 1.0, 2.0, 3.0, 5.0]).astype(np.float32))
        b = torch.arange(6, dtype=torch.float32)
        np.testing.assert_allclose(tpose._solve6(A, b).numpy(), np.linalg.solve(A.numpy(), b.numpy()), rtol=1e-6)
