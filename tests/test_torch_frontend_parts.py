"""Parity of the PyTorch port's front-end parts against the JAX package:
the synthetic renderer and the patch fetch exact; JAX features carried
across by convert.py keep every value and descriptor bit, and
search_by_bow on them equals the JAX package's exactly.
"""

import numpy as np
import pytest
import torch
from _torch_parity import jax_frontend_on_pair, np_of, shared_run

from orbslam2_tpu.datasets.synthetic import SyntheticWorld as JaxWorld
from orbslam2_tpu.ops import matchers as jmatch
from orbslam2_tpu_torch import convert
from orbslam2_tpu_torch.datasets.synthetic import SyntheticWorld
from orbslam2_tpu_torch.ops import matchers as tmatch
from orbslam2_tpu_torch.ops import patches as tpatches


@pytest.fixture(scope="module")
def jax_features(tmp_path_factory):
    """The JAX front end on tests/test_torch_frontend.py's stereo pair: its
    FrameFeatures and the extractor's features of both eyes, made once per
    session and shared with that file."""
    return shared_run(tmp_path_factory, "torch_frontend_jax_pair", jax_frontend_on_pair)


def test_synthetic_render_matches_jax():
    kw = dict(n_points=300, seed=3, baseline=0.2)
    T = JaxWorld(**kw).trajectory(2, step=0.06)[1]
    for a, b in zip(JaxWorld(**kw).render_stereo(T), SyntheticWorld(**kw).render_stereo(T)):
        np.testing.assert_array_equal(a, b)


def test_patch_fetch_matches_jax_window():
    """The plain patch fetch reads the same window the JAX extractor's
    dynamic-slice fallback reads from its aligned, padded image."""
    from orbslam2_tpu.ops import patches as jpatches

    rng = np.random.default_rng(0)
    img = rng.uniform(0, 255, (2, 60, 90)).astype(np.float32)
    xs = rng.integers(16, 90 - 16, (2, 7)).astype(np.int32)
    ys = rng.integers(16, 60 - 16, (2, 7)).astype(np.int32)
    imp = np.pad(img, [(0, 0), (24, 24), (24, 24)], mode="reflect")
    B, Hp, Wp = imp.shape
    jp = jpatches.extract_patches(
        imp.reshape(B * Hp, Wp), (xs + 3).reshape(-1), (ys + 3 + np.arange(B)[:, None] * Hp).reshape(-1)
    )
    tp = tpatches.extract_patches(tpatches.pad_level(torch.from_numpy(img)),
                                  torch.from_numpy(xs), torch.from_numpy(ys))
    np.testing.assert_array_equal(np_of(tp), np_of(jp))


def test_patch_fetch_clamps_window():
    """A keypoint outside the extractor's border reads the window whose start
    is clamped into the padded image, never outside it."""
    rng = np.random.default_rng(1)
    img = rng.uniform(0, 255, (1, 50, 70)).astype(np.float32)
    xs = np.array([[-40, 0, 35, 69, 200]], np.int32)
    ys = np.array([[-5, 49, 25, 300, 0]], np.int32)
    imp = tpatches.pad_level(torch.from_numpy(img))
    got = np_of(tpatches.extract_patches(imp, torch.from_numpy(xs), torch.from_numpy(ys)))
    padded = np_of(imp)[0]
    for k, (x, y) in enumerate(zip(xs[0], ys[0])):
        r0 = min(max(int(y) + 3, 0), padded.shape[0] - 48)
        c0 = min(max(int(x) + 3, 0), padded.shape[1] - 48)
        np.testing.assert_array_equal(got[k], padded[r0:r0 + 48, c0:c0 + 48])


def test_converted_features_and_search_by_bow(jax_features):
    """JAX FrameFeatures carried across by convert.py keep every value and
    descriptor bit; on the same inputs search_by_bow (reference-keyframe
    tracking) gives exactly the JAX package's (idx, best, keep)."""
    jfd, fj = jax_features
    tfd = convert.features_to_torch(jfd, "cpu")
    for name in jfd._fields:
        got = convert.desc_to_numpy(tfd.desc) if name == "desc" else np_of(getattr(tfd, name))
        np.testing.assert_array_equal(got, np_of(getattr(jfd, name)))
    right = (fj.desc[1], fj.valid[1], fj.angle[1])
    want = jmatch.search_by_bow(jfd.desc, jfd.valid, jfd.angle, *right, 0.7)
    got = tmatch.search_by_bow(
        tfd.desc, tfd.valid, tfd.angle, convert.desc_to_torch(right[0], "cpu"),
        convert.to_torch(right[1], "cpu"), convert.to_torch(right[2], "cpu"), 0.7,
    )
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np_of(g), np_of(w))
    assert np_of(want[2]).sum() > 100
