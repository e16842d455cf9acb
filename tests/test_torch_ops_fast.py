"""Parity of the PyTorch port's FAST score and NMS (the plain version of
kernel K2) and its ORB constant tables against the JAX package: exact.
The standalone 7x7 blur (`orb.gauss7`) is exact too; the intensity-centroid
angle (`orb.ic_angle`) is within 1e-4 rad: its two float32 moment sums over
the 31x31 disc are added in another order than XLA's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
from _torch_parity import both, np_of

from orbslam2_tpu.ops import fast as jfast
from orbslam2_tpu.ops import orb as jorb
from orbslam2_tpu_torch import convert
from orbslam2_tpu_torch.ops import fast as tfast
from orbslam2_tpu_torch.ops import orb as torb


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


def test_orb_tables_equal_jax():
    np.testing.assert_array_equal(convert.PATTERN, jorb._PATTERN)
    np.testing.assert_array_equal(convert.IC_MASK, jorb._IC_MASK)
    np.testing.assert_array_equal(convert.W2, jorb._W2)
    np.testing.assert_array_equal(convert.G7, jorb._G7)
    np.testing.assert_array_equal(convert.BLUR_BAND, jorb._BLUR_BAND)
    np.testing.assert_array_equal(convert.BIN_FLAT, jorb._BIN_FLAT)
    assert convert.BIN_FLAT.min() >= 0 and convert.BIN_FLAT.max() < 42 * 42


@pytest.mark.parametrize("fn", ["gauss7", "ic_angle"])
def test_gauss7_and_ic_angle_match_jax(fn):
    rng = np.random.default_rng(3)
    if fn == "gauss7":
        img = _test_image(4, h=40, w=56, integer=False)
        np.testing.assert_array_equal(np_of(torb.gauss7(both(img)[1])), np_of(jorb.gauss7(both(img)[0])))
        return
    img = _test_image(5, h=64, w=80, integer=False)[0]
    # tests/test_orb.py's cases on a flat image: a bright blob right of the
    # centre (angle ~0) and one below it (~pi/2); then random keypoints
    img[:, :64] = 50.0
    img[43:48, 25:31] = 250.0
    img[20:26, 43:48] = 250.0
    xs = np.concatenate([[17, 45], rng.integers(0, 80, 30)]).astype(np.int32)
    ys = np.concatenate([[45, 12], rng.integers(0, 64, 30)]).astype(np.int32)
    pad = np.pad(img, torb.EDGE, mode="reflect")
    assert torb.EDGE == jorb.EDGE
    (jp, tp), (jx, tx), (jy, ty) = both(pad), both(xs), both(ys)
    got, want = np_of(torb.ic_angle(tp, tx, ty)), np_of(jorb._ic_angle_single(jp, jx, jy))
    gap = np.abs(np.angle(np.exp(1j * (got.astype(np.float64) - want))))  # wrapped at +-pi
    assert gap.max() < 1e-4, gap.max()
    assert abs(got[0]) < 0.35 and abs(got[1] - np.pi / 2) < 0.35
