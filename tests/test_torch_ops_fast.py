"""Parity of the PyTorch port's FAST score and NMS (the plain version of
kernel K2) and its ORB constant tables against the JAX package: exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
from _torch_parity import both, np_of

from orbslam2_tpu.ops import fast as jfast
from orbslam2_tpu.ops import orb as jorb
from orbslam2_tpu_torch import convert
from orbslam2_tpu_torch.ops import fast as tfast


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
