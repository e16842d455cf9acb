"""Parity of the port's keypoint undistortion (`ops/undistort.py`, and the
frontend that applies it) and MLPnP (`ops/mlpnp.py`) against the JAX
package.

Stated tolerances:
  * undistort and distort on TUM-grade distortion: within 1e-3 px of the
    JAX package, and a Frontend with distortion gives the plain
    undistortion of its own raw keypoints exactly;
  * MLPnP RANSAC on the JAX package's own hypothesis indices (its
    Gumbel-top-6 draw from the same key): on exact bearings the pose
    within 1e-3 of JAX's and of the truth, the same inliers; on noisy
    bearings with 30% outliers the bars of tests/test_mlpnp.py
    (R 5e-3, t 3e-2, outliers < 10% inliers, clean > 85%), inlier counts
    within 2 of JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import slam_config
from test_mlpnp import make_problem
from test_undistort import CX, CY, DIST, FX, FY

from orbslam2_tpu.ops import mlpnp as jmlpnp
from orbslam2_tpu.ops import undistort as jund
from orbslam2_tpu_torch import config as torch_config
from orbslam2_tpu_torch.datasets.synthetic import SyntheticWorld
from orbslam2_tpu_torch.ops import mlpnp as tmlpnp
from orbslam2_tpu_torch.ops import orb
from orbslam2_tpu_torch.ops import undistort as tund
from orbslam2_tpu_torch.slam.frontend import Frontend


def test_undistort_and_distort_match_jax():
    rng = np.random.default_rng(3)
    uv = rng.uniform([0, 0], [640, 480], (800, 2)).astype(np.float32)
    for fn_j, fn_t in ((jund.undistort_points, tund.undistort_points), (jund.distort_points, tund.distort_points)):
        want = np.asarray(fn_j(jnp.asarray(uv), FX, FY, CX, CY, **DIST))
        got = fn_t(torch.from_numpy(uv), FX, FY, CX, CY, **DIST)
        assert got.dtype == torch.float32
        assert np.abs(got.numpy() - want).max() < 1e-3
    # no distortion: the identity
    np.testing.assert_allclose(tund.undistort_points(torch.from_numpy(uv), FX, FY, CX, CY).numpy(), uv, atol=1e-4)


def test_frontend_undistorts_keypoints():
    world = SyntheticWorld(n_points=300, seed=2, baseline=0.2)
    cfg = slam_config(world, torch_config)
    cfg.orb.n_features = 300
    imL, imR = world.render_stereo(world.trajectory(1)[0])
    plain = Frontend(cfg, "cpu")
    for k, v in DIST.items():
        setattr(cfg.camera, k, v)
    fe = Frontend(cfg, "cpu")
    assert fe.has_distortion and not plain.has_distortion
    c = cfg.camera
    for mono in (False, True):
        if mono:
            got, raw = fe.process_mono(imL), plain.process_mono(imL)
            assert bool((got.u_right == -1).all()) and bool((got.depth == -1).all())
            # K1 and K2 take the one image: the left eye's features of a pair
            f = orb.extract(torch.from_numpy(np.asarray(imL)[None]).float(), fe.orb_params)
            assert torch.equal(raw.desc, f.desc[0])
        else:
            got, raw = fe.process(imL, imR), plain.process(imL, imR)
        want = tund.undistort_points(raw.uv, c.fx, c.fy, c.cx, c.cy, c.k1, c.k2, c.p1, c.p2, c.k3)
        assert torch.equal(got.uv, want) and not torch.equal(got.uv, raw.uv)
        for name in ("octave", "desc", "valid", "u_right"):
            assert torch.equal(getattr(got, name), getattr(raw, name)), name


@pytest.mark.parametrize("noisy", [False, True])
def test_mlpnp_ransac_matches_jax(noisy):
    rng = np.random.default_rng(0)
    n = 150
    pw, v, T, out_idx = make_problem(rng, n=n, noise_rad=2e-4 if noisy else 0.0, outlier_frac=0.3 if noisy else 0.0)
    cos_th = jnp.full(n, np.cos(np.radians(0.5)))
    key = jax.random.PRNGKey(0)
    jr = jax.jit(jmlpnp.mlpnp_ransac, static_argnames=("n_hyp",))(key, pw, v, jnp.ones(n, bool), cos_th)
    idx = np.asarray(jax.lax.top_k(jax.random.gumbel(key, (128, n)), 6)[1])  # mlpnp.py:139-141
    t = lambda a: torch.from_numpy(np.asarray(a).copy())  # noqa: E731
    tr = tmlpnp.mlpnp_ransac_from_hypotheses(t(idx), t(pw), t(v), torch.ones(n, dtype=torch.bool), t(cos_th))
    Tt, Tj = tr.Tcw.numpy(), np.asarray(jr.Tcw, np.float64)
    inl = tr.inliers.numpy()
    if not noisy:
        assert np.abs(Tt - Tj).max() < 1e-3 and np.abs(Tt - T).max() < 1e-3
        np.testing.assert_array_equal(inl, np.asarray(jr.inliers))
    else:
        np.testing.assert_allclose(Tt[:3, :3], T[:3, :3], atol=5e-3)
        np.testing.assert_allclose(Tt[:3, 3], T[:3, 3], atol=3e-2)
        assert inl[out_idx].mean() < 0.1
        assert inl[np.setdiff1d(np.arange(n), out_idx)].mean() > 0.85
        assert abs(int(tr.n_inliers) - int(jr.n_inliers)) <= 2
    # the exact-data solve and the bearings against the JAX package
    pw6, v6, T6, _ = make_problem(np.random.default_rng(4), n=60)
    Ts = tmlpnp.mlpnp_solve(t(pw6), t(v6), torch.ones(60)).numpy()
    assert np.abs(Ts - np.asarray(jmlpnp.mlpnp_solve(pw6, v6, jnp.ones(60)))).max() < 1e-3
    assert np.abs(Ts - T6).max() < 1e-3
    uv = np.array([[376.0, 240.0], [10.0, 470.0]], np.float32)
    np.testing.assert_allclose(tmlpnp.bearings_from_pixels(t(uv), 458.0, 457.0, 376.0, 240.0).numpy(),
                               np.asarray(jmlpnp.bearings_from_pixels(jnp.asarray(uv), 458.0, 457.0, 376.0, 240.0)),
                               atol=1e-6)
