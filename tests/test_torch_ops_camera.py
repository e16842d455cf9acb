"""Parity of the PyTorch port's se3 transforms and quaternions and its
stereo camera against the JAX package, <= 1e-5 (absolute plus 1e-5
relative), the frustum mask exact.
"""

import jax.numpy as jnp
import numpy as np
from _torch_parity import both, np_of, random_xi

from orbslam2_tpu.geometry import camera as jcam
from orbslam2_tpu.geometry import se3 as jse3
from orbslam2_tpu_torch.geometry import camera as tcam
from orbslam2_tpu_torch.geometry import se3 as tse3

TOL_GEOM = 1e-5


class TestSE3:
    def test_transform_hat_retract_inverse(self):
        rng = np.random.default_rng(2)
        T = np.asarray(jse3.exp(jnp.asarray(random_xi(rng, 16))))
        p = rng.uniform(-5, 5, (16, 3)).astype(np.float32)
        dx = random_xi(rng, 16, rot=0.05, trans=0.1)
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
        xi = random_xi(rng, 64, rot=3.0)
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
        T = np.asarray(jse3.exp(jnp.asarray(random_xi(rng, 1, rot=0.1, trans=0.5)[0])))
        args = [both(a) for a in (T, pw, normal, np.full(300, 1.0, np.float32),
                                  np.full(300, 25.0, np.float32))]
        jc, tc = jcam.make_camera(*self.ARGS), tcam.make_camera(*self.ARGS)
        out_j = jcam.is_in_frustum(jc, *[a[0] for a in args])
        out_t = tcam.is_in_frustum(tc, *[a[1] for a in args])
        np.testing.assert_array_equal(np_of(out_t[0]), np_of(out_j[0]))
        for t, j in zip(out_t[1:], out_j[1:]):
            np.testing.assert_allclose(np_of(t), np_of(j), rtol=TOL_GEOM, atol=TOL_GEOM)
