"""The port's Sim3 group and Sim3 solver against the JAX package's, on the
CPU, on the same numpy inputs from a seed.

Stated tolerances:
  * `geometry/sim3.py` exp, log, compose, inverse, retract, apply,
    to_se3 and the 4x4 matrix: 1e-5 (float32 in both packages here; near
    the identity, at the small-sigma and small-angle thresholds and at
    rotations of ~2 rad); from_se3 and identity exactly;
  * `horn_sim3` with fixed and free scale: 1e-5 (the port solves in
    float64, the JAX package in float32);
  * `sim3_ransac` fed the hypothesis indices that JAX's gumbel top_k draws
    from the same key: the same inliers and count, S12 within 1e-4;
    with its own draw (the caller's generator) it finds the same inliers;
  * `optimize_sim3` from the RANSAC's S12 and inliers: the same inliers,
    S12 within 1e-4.
The essential graph is held against the JAX package's in
tests/test_torch_loop_closing.py, which compiles the JAX solver once for
both of its problems.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import np_of

from orbslam2_tpu.geometry import camera as jcam
from orbslam2_tpu.geometry import se3 as jse3
from orbslam2_tpu.geometry import sim3 as jsim3
from orbslam2_tpu.ops import sim3solve as jsolve
from orbslam2_tpu_torch import convert
from orbslam2_tpu_torch.geometry import camera as tcam
from orbslam2_tpu_torch.geometry import sim3 as tsim3
from orbslam2_tpu_torch.ops import sim3solve as tsolve

CAM = (458.0, 457.0, 376.0, 240.0)


def _t(a, dtype=None):
    return torch.from_numpy(np.array(a, dtype=dtype))


def _close(S_jax, S_torch, atol):
    for a, b in zip(S_jax, S_torch):
        np.testing.assert_allclose(np_of(b), np.asarray(a), atol=atol, rtol=0)


def test_group_ops_match_jax():
    for scale in (1e-7, 1e-3, 0.3, 1.2):
        _group_ops_match_jax(scale)


def _group_ops_match_jax(scale):
    rng = np.random.default_rng(int(scale * 1e7) % 1000)
    xi = (rng.normal(size=(8, 7)) * scale).astype(np.float32)
    xi[0, :3] = 0.0  # pure translation and scale
    xi[1, 6] = 0.0  # no scale
    xi[2, 6] = 3e-6  # below the small-sigma threshold
    xi[3, :3] = 5e-6  # below the small-angle threshold
    d = (rng.normal(size=(8, 7)) * 0.2).astype(np.float32)
    p = rng.normal(size=(8, 3)).astype(np.float32)
    J, T = jsim3.exp(jnp.asarray(xi)), tsim3.exp(_t(xi))
    _close(J, T, 1e-5)
    np.testing.assert_allclose(np_of(tsim3.log(T)), np.asarray(jsim3.log(J)), atol=1e-5, rtol=0)
    Jd, Td = jsim3.exp(jnp.asarray(d)), tsim3.exp(_t(d))
    _close(jsim3.compose(J, Jd), tsim3.compose(T, Td), 1e-5)
    _close(jsim3.inverse(J), tsim3.inverse(T), 1e-5)
    _close(jsim3.retract(J, jnp.asarray(d)), tsim3.retract(T, _t(d)), 1e-5)
    np.testing.assert_allclose(np_of(tsim3.apply(T, _t(p))), np.asarray(jsim3.apply(J, jnp.asarray(p))),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(np_of(tsim3.to_se3(T)), np.asarray(jsim3.to_se3(J)), atol=1e-5, rtol=0)
    np.testing.assert_allclose(np_of(T.matrix()), np.asarray(J.matrix()), atol=1e-5, rtol=0)
    Tse3 = tsim3.to_se3(T)
    _close(jsim3.from_se3(jnp.asarray(np_of(Tse3))), tsim3.from_se3(Tse3), 0.0)
    _close(jsim3.identity((2,)), tsim3.identity((2,)), 0.0)
    # the carrier holds the values
    _close(J, convert.sim3_to_torch(J, "cpu", torch.float32), 0.0)


def _problem(rng, n=80, n_out=20, noise=0.5):
    """Matched points of two keyframes related by a Sim3, a share of them
    outliers, the pixels with noise: (X1, X2, uv1, uv2, valid) numpy."""
    cam = jcam.make_camera(*CAM, bf=47.9, width=752, height=480)
    R = np.asarray(jse3.exp_so3(jnp.asarray([0.05, -0.1, 0.03])))
    t = np.array([0.4, 0.1, -0.2], np.float32)
    X2 = rng.uniform([-2, -2, 4], [2, 2, 15], (n, 3)).astype(np.float32)
    X1 = (X2 @ R.T + t).astype(np.float32)
    out = rng.choice(n, n_out, replace=False)
    X1[out] += rng.uniform(1, 3, (n_out, 3)).astype(np.float32)
    uv1 = np.asarray(jcam.project(cam, jnp.asarray(X1))) + rng.normal(0, noise, (n, 2)).astype(np.float32)
    uv2 = np.asarray(jcam.project(cam, jnp.asarray(X2))) + rng.normal(0, noise, (n, 2)).astype(np.float32)
    valid = rng.uniform(size=n) > 0.1
    return X1, X2, uv1.astype(np.float32), uv2.astype(np.float32), valid


def test_horn_matches_jax(rng):
    X1, X2, *_ = _problem(rng, n_out=0)
    w = rng.uniform(0.2, 1.0, len(X1)).astype(np.float32)
    X1s = (1.7 * X1).astype(np.float32)
    for fix_scale, P1 in ((True, X1), (False, X1s)):
        J = jsolve.horn_sim3(jnp.asarray(P1), jnp.asarray(X2), jnp.asarray(w), fix_scale=fix_scale)
        T = tsolve.horn_sim3(_t(P1, np.float64), _t(X2, np.float64), _t(w, np.float64), fix_scale)
        _close(J, T, 1e-5)


@pytest.fixture(scope="module")
def ransac():
    """JAX's sim3_ransac and optimize_sim3 and the port's on one problem,
    the port's RANSAC fed JAX's hypothesis indices."""
    rng = np.random.default_rng(5)
    X1, X2, uv1, uv2, valid = _problem(rng)
    maxe = np.full(len(X1), 9.21, np.float32)
    jc = jcam.make_camera(*CAM, bf=47.9, width=752, height=480)
    tc = tcam.make_camera(*CAM, bf=47.9, width=752, height=480)
    key = jax.random.PRNGKey(3)
    jr = jax.jit(jsolve.sim3_ransac, static_argnames=("fix_scale", "n_hyp"))(
        key, *(jnp.asarray(a) for a in (X1, X2, uv1, uv2, maxe, maxe, valid)), jc)
    # the indices JAX's draw takes from the same key (sim3solve.py:108-111)
    g = jax.random.gumbel(key, (128, len(X1))) + jnp.where(jnp.asarray(valid), 0.0, -1e9)[None, :]
    idx = np.asarray(jax.lax.top_k(g, 3)[1])
    args = [_t(a) for a in (X1, X2, uv1, uv2, maxe, maxe, valid)]
    tr = tsolve.sim3_ransac(*args, tc, hypotheses=_t(idx))
    gen = torch.Generator().manual_seed(7)
    tr_own = tsolve.sim3_ransac(*args, tc, generator=gen)
    ones = np.ones(len(X1), np.float32)
    jo = jax.jit(jsolve.optimize_sim3, static_argnames=("fix_scale", "n_iters"))(
        jr.S12, *(jnp.asarray(a) for a in (X1, X2, uv1, uv2, ones, ones)), jr.inliers, jc)
    to = tsolve.optimize_sim3(convert.sim3_to_torch(jr.S12, "cpu"), *args[:4], _t(ones), _t(ones),
                              _t(np.asarray(jr.inliers)), tc)
    return dict(jr=jr, tr=tr, tr_own=tr_own, jo=jo, to=to, n=len(X1))


def test_sim3_ransac_matches_jax(ransac):
    jr, tr = ransac["jr"], ransac["tr"]
    assert int(tr.n_inliers) == int(jr.n_inliers) >= 50
    np.testing.assert_array_equal(np_of(tr.inliers), np.asarray(jr.inliers))
    _close(jr.S12, tr.S12, 1e-4)
    np.testing.assert_array_equal(np_of(ransac["tr_own"].inliers), np.asarray(jr.inliers))


def test_optimize_sim3_matches_jax(ransac):
    (jS, jinl, jn), (tS, tinl, tn) = ransac["jo"], ransac["to"]
    assert int(tn) == int(jn) >= 50
    np.testing.assert_array_equal(np_of(tinl), np.asarray(jinl))
    _close(jS, tS, 1e-4)
