"""Parity of the PyTorch port's front end (ORB extraction + stereo
matching) against the JAX package on one 752x480 synthetic stereo pair.
The renderer, the patch fetch and the feature conversion are held in
tests/test_torch_frontend_parts.py.

Stated tolerances:
  * level-0 keypoints exact (the pyramid's level 0 is the image itself);
  * (uv, octave) of valid keypoints agree on >= 99% overall (the cascaded
    bilinear resize matches `jax.image.resize` only to ~6e-5, so a FAST
    threshold can flip at levels >= 1);
  * angle within 1e-4 rad on common keypoints;
  * descriptor bit error rate < 1% on common keypoints;
  * u_right / depth within 1e-4 where both sides matched, and the matched
    sets agree on >= 99%.
"""

import numpy as np
import pytest
import torch
from _torch_parity import frontend_pair, jax_frontend_on_pair, np_of, shared_run, slam_config

from orbslam2_tpu.ops import orb as jorb
from orbslam2_tpu_torch import config as torch_config
from orbslam2_tpu_torch.ops import orb as torb
from orbslam2_tpu_torch.slam.frontend import Frontend


@pytest.fixture(scope="module")
def features(tmp_path_factory):
    """(JAX FrameFeatures, the port's, JAX extractor features, the port's)
    of the pair; the JAX package's part is made once per session, shared
    with tests/test_torch_frontend_parts.py."""
    world, images = frontend_pair()
    jfd, fj = shared_run(tmp_path_factory, "torch_frontend_jax_pair", jax_frontend_on_pair)
    tf = Frontend(slam_config(world, torch_config), device="cpu")
    ft = torb.extract(torch.from_numpy(images), tf.orb_params)
    return jfd, tf.features_body(torch.from_numpy(images)), fj, ft


def _keys(uv, octave, valid):
    return {
        (round(float(u) * 64), round(float(v) * 64), int(o))
        for (u, v), o, ok in zip(uv, octave, valid) if ok
    }


def _common(fj, ft, b):
    """Slot pairs (i_jax, i_torch) of the same keypoint (uv, octave) in eye b."""
    index = {}
    for i, ((u, v), o, ok) in enumerate(zip(np_of(fj.uv[b]), np_of(fj.octave[b]), np_of(fj.valid[b]))):
        if ok:
            index[(float(u), float(v), int(o))] = i
    pairs = []
    for i, ((u, v), o, ok) in enumerate(zip(np_of(ft.uv[b]), np_of(ft.octave[b]), np_of(ft.valid[b]))):
        j = index.get((float(u), float(v), int(o)))
        if ok and j is not None:
            pairs.append((j, i))
    return np.asarray(pairs)


def test_level0_keypoints_exact(features):
    _, _, fj, ft = features
    n0 = jorb.features_per_level(jorb.OrbParams())[0]
    for name in ("uv", "octave", "response", "valid"):
        np.testing.assert_array_equal(np_of(getattr(ft, name))[:, :n0], np_of(getattr(fj, name))[:, :n0])
    assert np_of(ft.valid)[:, :n0].sum() > 300


def test_keypoints_agree(features):
    _, _, fj, ft = features
    for b in range(2):
        kj = _keys(np_of(fj.uv[b]), np_of(fj.octave[b]), np_of(fj.valid[b]))
        kt = _keys(np_of(ft.uv[b]), np_of(ft.octave[b]), np_of(ft.valid[b]))
        agree = len(kj & kt) / max(len(kj | kt), 1)
        assert agree >= 0.99, (b, agree, len(kj), len(kt))


def test_angle_and_descriptors(features):
    _, _, fj, ft = features
    for b in range(2):
        pairs = _common(fj, ft, b)
        assert len(pairs) > 1000
        aj = np_of(fj.angle[b])[pairs[:, 0]]
        at = np_of(ft.angle[b])[pairs[:, 1]]
        dang = np.abs(np.angle(np.exp(1j * (aj.astype(np.float64) - at))))
        assert dang.max() <= 1e-4, dang.max()
        dj = np_of(fj.desc[b])[pairs[:, 0]]
        dt = np_of(ft.desc[b])[pairs[:, 1]].view(np.uint32)
        ber = np.unpackbits((dj ^ dt).view(np.uint8)).mean()
        assert ber < 0.01, ber


def test_stereo_depth(features):
    jfd, tfd, fj, ft = features
    pairs = _common(fj, ft, 0)
    mj = np_of(jfd.depth)[pairs[:, 0]] > 0
    mt = np_of(tfd.depth)[pairs[:, 1]] > 0
    assert mj.sum() > 300
    assert (mj == mt).mean() >= 0.99, (mj == mt).mean()
    both_m = mj & mt
    for name in ("u_right", "depth"):
        a = np_of(getattr(jfd, name))[pairs[:, 0]][both_m]
        b = np_of(getattr(tfd, name))[pairs[:, 1]][both_m]
        np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-4)
