"""Parity of the PyTorch port's Hamming distances and masked best and
second best (the plain version of kernel K3) against the JAX package:
exact, all-masked rows and ties included.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import both, desc_both, np_of, random_descs

from orbslam2_tpu.ops import hamming as jham
from orbslam2_tpu_torch.ops import hamming as tham


class TestHamming:
    @pytest.mark.parametrize("ties", [False, True])
    def test_matrix_and_best2_exact(self, ties):
        rng = np.random.default_rng(7)
        A, B = random_descs(rng, 40, ties), random_descs(rng, 57, ties)
        mask = rng.uniform(size=(40, 57)) < 0.3
        mask[:5] = False  # all-masked rows
        mask[5, :] = False
        mask[5, 9] = True  # a single candidate
        (jA, tA), (jB, tB) = desc_both(A), desc_both(B)
        jm, tm = both(mask)

        dj = jham.hamming_matrix(jA, jB)
        np.testing.assert_array_equal(np_of(tham.hamming_matrix(tA, tB)), np_of(dj))
        ref = np.unpackbits((A[:, None] ^ B[None]).view(np.uint8), axis=-1).sum(-1)
        np.testing.assert_array_equal(np_of(dj), ref)

        i1, d1 = jham.masked_argmin(dj, jm)
        k1, b1, s1 = jham.masked_two_smallest(dj, jm)
        # the second-index pass of search_by_projection_points
        choice = jax.nn.one_hot(k1, dj.shape[1], dtype=bool)
        i2 = jnp.argmin(jnp.where(jm & ~choice, dj, jham.MAX_DIST), axis=-1)
        out = [np_of(x) for x in tham.best2(tA, tB, tm)]
        np.testing.assert_array_equal(out[0], np_of(i1))
        np.testing.assert_array_equal(out[1], np_of(d1))
        np.testing.assert_array_equal(out[0], np_of(k1))
        np.testing.assert_array_equal(out[1], np_of(b1))
        np.testing.assert_array_equal(out[2], np_of(i2))
        np.testing.assert_array_equal(out[3], np_of(s1))
        assert (out[1][:5] == 256).all() and (out[0][:5] == 0).all()
        assert (out[3][5] == 256) and (out[2][5] == 0)

        tdist = tham.hamming_matrix(tA, tB)
        for fn_t, fn_j in ((tham.masked_argmin, jham.masked_argmin),
                           (tham.masked_two_smallest, jham.masked_two_smallest)):
            for t, j in zip(fn_t(tdist, tm), fn_j(dj, jm)):
                np.testing.assert_array_equal(np_of(t), np_of(j))

    def test_popcount_sign_bit(self):
        words = np.array([0, 1, 0x80000000, 0xFFFFFFFF, 0x7FFFFFFF, 0xAAAAAAAA], np.uint32)
        t = torch.from_numpy(words.view(np.int32).copy())
        want = [bin(int(w)).count("1") for w in words]
        assert tham.popcount32(t).tolist() == want
