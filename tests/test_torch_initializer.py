"""Parity of the port's two-view initializer and triangulation
(`orbslam2_tpu_torch/ops/initializer.py`, `geometry/triangulation.py`)
against the JAX package, on the scenes of tests/test_initializer.py.

Both get the same matches and the JAX package's own hypothesis indices
(its Gumbel-top-8 draw from the same key). Stated tolerances:
  * against the JAX package run in float64 (`jax.enable_x64`, the port's
    precision), on its float64 draw: the same success, model and point
    mask, T21 within 1e-4;
  * against the JAX package as it runs (float32): the same success and
    model, the bars of tests/test_initializer.py on the port's T21, T21
    within 1e-3 of JAX's (the float32 8-point solve on 0.3 px of noise
    moves it up to ~4e-4), and the same point mask but for points within
    1e-3 of a gate;
  * triangulation on float32 inputs: X within 1e-3 of JAX's relative to
    the distance, the same ok mask.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import rot_err
from test_initializer import make_two_view

from orbslam2_tpu.geometry import triangulation as jtri
from orbslam2_tpu.ops import initializer as jinit
from orbslam2_tpu_torch.geometry import camera as tcamera
from orbslam2_tpu_torch.geometry import triangulation as ttri
from orbslam2_tpu_torch.ops import initializer as tinit

# scene -> (make_two_view arguments, PRNG key of tests/test_initializer.py)
SCENES = {
    "general": (dict(planar=False), 0),
    "planar": (dict(planar=True), 1),
    "no_parallax": (dict(tx=0.0005, noise=0.0), 3),
}


def _jax_hypotheses(key, valid, n_hyp=200):
    """The JAX initializer's draw (ops/initializer.py:257-259)."""
    g = jax.random.gumbel(key, (n_hyp, valid.shape[0])) + jnp.where(valid, 0.0, -1e9)[None]
    return np.asarray(jax.lax.top_k(g, 8)[1])


def _port(idx, cam, uv1, uv2, valid):
    c = tcamera.make_camera(cam.fx, cam.fy, cam.cx, cam.cy, width=cam.width, height=cam.height)
    t = lambda a: torch.from_numpy(np.asarray(a).copy())  # noqa: E731
    return tinit.initialize_two_view_from_hypotheses(t(idx), t(uv1), t(uv2), t(valid), c)


@pytest.mark.parametrize("scene", list(SCENES))
def test_two_view_matches_jax(scene):
    kw, seed = SCENES[scene]
    cam, uv1, uv2, valid, T2, _ = make_two_view(np.random.default_rng(0), **kw)
    key = jax.random.PRNGKey(seed)

    # float32, as the JAX package runs
    jr = jax.jit(jinit.initialize_two_view)(key, uv1, uv2, valid, cam)
    tr = _port(_jax_hypotheses(key, valid), cam, uv1, uv2, valid)
    assert bool(tr.success) == bool(jr.success)
    assert bool(tr.used_homography) == bool(jr.used_homography)
    Tt, Tj = tr.T21.numpy(), np.asarray(jr.T21, np.float64)
    assert np.abs(Tt - Tj).max() < 1e-3
    if scene == "general":
        assert bool(tr.success) and not bool(tr.used_homography)
        assert np.abs(Tt[:3, :3] - T2[:3, :3]).max() < 0.03
        assert np.abs(Tt[:3, 3] - T2[:3, 3] / np.linalg.norm(T2[:3, 3])).max() < 0.05
    elif scene == "planar":
        assert bool(tr.success) and bool(tr.used_homography)
        assert np.abs(Tt[:3, :3] - T2[:3, :3]).max() < 2e-2
    else:
        assert not bool(tr.success)
    differ = np.nonzero(tr.point_ok.numpy() != np.asarray(jr.point_ok))[0]
    assert len(differ) <= 2, differ

    # float64 on both sides, on the float64 draw
    with jax.enable_x64(True):
        u1, u2 = (jnp.asarray(np.asarray(a), jnp.float64) for a in (uv1, uv2))
        jr64 = jax.jit(jinit.initialize_two_view)(key, u1, u2, valid, cam)
        idx64 = _jax_hypotheses(key, valid)
        T64 = np.asarray(jr64.T21)
        ok64, succ64, h64 = np.asarray(jr64.point_ok), bool(jr64.success), bool(jr64.used_homography)
    tr = _port(idx64, cam, uv1, uv2, valid)
    assert bool(tr.success) == succ64 and bool(tr.used_homography) == h64
    assert np.abs(tr.T21.numpy() - T64).max() < 1e-4
    assert rot_err(tr.T21.numpy()[:3, :3], T64[:3, :3]) < 1e-4
    np.testing.assert_array_equal(tr.point_ok.numpy(), ok64)


def test_triangulation_matches_jax():
    rng = np.random.default_rng(5)
    n = 500
    X = np.stack([rng.uniform(-4, 4, n), rng.uniform(-3, 3, n), rng.uniform(2, 30, n)], 1)
    R2 = np.linalg.qr(np.eye(3) + 0.05 * rng.normal(size=(3, 3)))[0]
    R2 *= np.sign(np.linalg.det(R2))
    t2 = np.array([0.5, -0.1, 0.05])
    P1 = np.eye(4)[:3].astype(np.float32)
    P2 = np.concatenate([R2, t2[:, None]], 1).astype(np.float32)
    x2c = X @ R2.T + t2
    xn1 = (X[:, :2] / X[:, 2:] + rng.normal(0, 1e-3, (n, 2))).astype(np.float32)
    xn2 = (x2c[:, :2] / x2c[:, 2:] + rng.normal(0, 1e-3, (n, 2))).astype(np.float32)
    xn2[:5] = xn1[:5]  # no parallax in the first rows (far points)
    Xj, okj = jtri.triangulate_dlt(jnp.asarray(P1)[None], jnp.asarray(P2)[None], jnp.asarray(xn1), jnp.asarray(xn2))
    t = torch.from_numpy
    Xt, okt = ttri.triangulate_dlt(t(P1)[None], t(P2)[None], t(xn1), t(xn2))
    assert Xt.dtype == torch.float32
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    Xj, Xt = np.asarray(Xj, np.float64), Xt.numpy().astype(np.float64)
    ok = np.asarray(okj)
    rel = np.linalg.norm(Xt - Xj, axis=1) / np.linalg.norm(Xj, axis=1)
    assert rel[ok][5:].max() < 1e-3
    O2 = -R2.T @ t2
    cj = np.asarray(jtri.rays_parallax_cos(jnp.zeros(3), jnp.asarray(O2, jnp.float32), jnp.asarray(X, jnp.float32)))
    ct = ttri.rays_parallax_cos(torch.zeros(3), t(O2.astype(np.float32)), t(X.astype(np.float32))).numpy()
    np.testing.assert_allclose(ct, cj, atol=1e-6)
