"""Parity of the PyTorch port's se3 exp and log against the JAX package,
<= 1e-5 (absolute plus 1e-5 relative: the float32 libm calls differ
between the frameworks, and (1 - cos t)/t^2 amplifies that near small
angles).
"""

import numpy as np
import pytest
from _torch_parity import both, np_of, random_xi

from orbslam2_tpu.geometry import se3 as jse3
from orbslam2_tpu_torch.geometry import se3 as tse3

TOL_GEOM = 1e-5


class TestSE3:
    @pytest.mark.parametrize("scale", [1e-6, 1e-2, 0.5, 3.0])
    def test_exp_log(self, scale):
        rng = np.random.default_rng(1)
        xi = random_xi(rng, 64, rot=scale, trans=2.0)
        jx, tx = both(xi)
        Tj, Tt = jse3.exp(jx), tse3.exp(tx)
        np.testing.assert_allclose(np_of(Tt), np_of(Tj), rtol=TOL_GEOM, atol=TOL_GEOM)
        np.testing.assert_allclose(np_of(tse3.log(Tt)), np_of(jse3.log(Tj)), rtol=TOL_GEOM, atol=TOL_GEOM)
