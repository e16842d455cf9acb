"""Parity of the PyTorch port's pose optimization (the plain version of
kernel K5) against the JAX package: within 1e-3 rad / 1e-3 m with inlier
masks equal on >= 99% of edges. The port's other ops are held in
tests/test_torch_ops_*.py, files of at most four tests each.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from _torch_parity import both, np_of, rot_err

from orbslam2_tpu.geometry import camera as jcam
from orbslam2_tpu.geometry import se3 as jse3
from orbslam2_tpu.ops import pose_opt as jpose
from orbslam2_tpu_torch.geometry import camera as tcam
from orbslam2_tpu_torch.ops import pose_opt as tpose

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
        assert tpose._solve6([[0.0] * 6] * 6, [0.0] * 6) == [0.0] * 6
        A = np.diag([4.0, 9.0, 1.0, 2.0, 3.0, 5.0])
        b = np.arange(6.0)
        np.testing.assert_allclose(tpose._solve6(A.tolist(), b.tolist()), np.linalg.solve(A, b), rtol=1e-6)
