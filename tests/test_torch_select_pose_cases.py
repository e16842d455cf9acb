"""The plain versions of K5 (the pose LM) and K6 (keypoint selection)
against the JAX package's functions on the edge cases of
`orbslam2_tpu_torch/kernels/cases.py`, on the CPU; the card holds the
kernels to these plain versions on the same cases (chip_smoke.py,
tests/test_torch_kernels.py).

Also the pieces of the plain versions that this port changed on the CPU:
the plain LM's host retract against `geometry/se3.py` and the JAX
package's, and the plain FAST score (computed in bands of rows) and its
NMS against the JAX package's over several bands and images.

Stated tolerances: the pose within 1e-3 rad and 1e-3 m of the JAX
package's float32 LM and inlier masks equal on >= 99% of the edges (the
bars of tests/test_torch_ops.py::TestPoseOptimize: the port solves in
float64); where no edge is valid, or every edge is an outlier after the
first round, the pose is T0 exactly and no edge is an inlier. The
selection is exact: x, y, response and valid of every slot of every
level, an empty slot's x and y clamped to the 16 px border as the
extractor clamps them. The retract within 1e-12 of float64 se3.retract
and 1e-6 of the JAX package's float32 one; FAST and NMS exact.
"""

import functools

import jax
import numpy as np
import torch
from _torch_parity import np_of, rot_err

from orbslam2_tpu.geometry import camera as jcam
from orbslam2_tpu.geometry import se3 as jse3
from orbslam2_tpu.ops import fast as jfast
from orbslam2_tpu.ops import orb as jorb
from orbslam2_tpu.ops import pose_opt as jpose
from orbslam2_tpu_torch.geometry import se3
from orbslam2_tpu_torch.kernels import cases
from orbslam2_tpu_torch.ops import fast, orb, pose_opt

# every pose case goes to the JAX LM padded with invalid edges to one
# size, so that it compiles once
N_PAD = 1200


def _pad(args, n):
    T0, pw, obs, isig, ster, valid = args
    k = n - len(valid)
    return [T0] + [np.concatenate([a, np.zeros((k,) + a.shape[1:], a.dtype)]) for a in (pw, obs, isig, ster, valid)]


def test_pose_lm_cases_match_jax():
    cam = jcam.make_camera(*cases.K5_CAMERA)
    jit_pose = jax.jit(lambda *a: jpose.pose_optimize(*a, cam))
    for (name, raw), (_, args, tcam) in zip(cases.k5_raw_cases(), cases.k5_cases("cpu")):
        rj = jit_pose(*_pad(raw, N_PAD))
        rt = pose_opt.pose_optimize(*args, tcam)
        Tj, Tt = np_of(rj.Tcw), np_of(rt.Tcw)
        n = len(raw[5])
        assert np.isfinite(Tt).all(), name
        assert rot_err(Tt[:3, :3], Tj[:3, :3]) <= 1e-3, name
        assert np.abs(Tt[:3, 3] - Tj[:3, 3]).max() <= 1e-3, name
        assert (np_of(rt.inlier) == np_of(rj.inlier)[:n]).mean() >= 0.99, name
        if not raw[5].any() or name.startswith("every edge an outlier"):
            np.testing.assert_array_equal(Tt, raw[0], err_msg=name)
            assert int(rt.n_inliers) == 0 and not np_of(rj.inlier).any(), name


@functools.lru_cache(maxsize=None)
def _jax_select(n_target):
    return jax.jit(lambda s: jorb._select_level_keypoints(s, n_target, 20.0, 7.0))


def test_select_keypoints_cases_match_jax():
    for (name, levels, budgets), (_, tlevels, _) in zip(cases.k6_raw_cases(), cases.k6_cases("cpu")):
        got = orb.select_keypoints_levels(tlevels, budgets, 20.0, 7.0)
        for lvl, (s, n_t) in enumerate(zip(levels, budgets)):
            xs, ys, resp, valid = (np.asarray(a) for a in _jax_select(n_t)(s))
            want = (np.where(valid, xs, orb.KP_BORDER), np.where(valid, ys, orb.KP_BORDER), resp, valid)
            for i, w in enumerate(want):
                np.testing.assert_array_equal(np_of(got[i][lvl]), w, err_msg=f"{name}, level {lvl}, output {i}")
            assert got[0][lvl].dtype == got[1][lvl].dtype == torch.int32


def test_host_retract_matches_se3():
    """The plain LM's retract in float64 scalars (both branches of the
    small-angle switch at theta2 = 1e-8) against se3.retract."""
    rng = np.random.default_rng(3)
    T = se3.exp(torch.from_numpy(rng.normal(0, 0.5, 6)))
    for scale in (0.0, 1e-9, 5e-5, 1e-4, 1e-2, 0.7):
        dx = rng.normal(0, 1, 6) * scale
        got = np.asarray(pose_opt._retract(T[:3].tolist(), dx.tolist()))
        want = se3.retract(T, torch.from_numpy(dx)).numpy()[:3]
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12, err_msg=str(scale))
        jwant = np.asarray(jse3.retract(T.numpy().astype(np.float32), dx.astype(np.float32)))[:3]
        np.testing.assert_allclose(got, jwant, rtol=0, atol=1e-6, err_msg=str(scale))


def test_fast_score_in_bands_matches_jax():
    """Three images of 200 x 300 take bands of 18 rows and a ragged last
    band; integer and fractional intensities."""
    rng = np.random.default_rng(4)
    img = rng.uniform(0, 255, (3, 200, 300)).astype(np.float32)
    img[1] = np.round(img[1])
    img[2, ::2] = img[2, ::2] * 0.25
    want = np.asarray(jfast.fast_score(img))
    got = fast.fast_score(torch.from_numpy(img))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(fast.nms3(got).numpy(), np.asarray(jfast.nms3(want)))
    assert (want > 0).mean() > 0.1
