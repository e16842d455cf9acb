"""The port's stereo and frame-projection matchers against the JAX
package's, on the CPU (the local-map matcher and K3's candidate rule are
in tests/test_torch_k3_gates.py).

Inputs: the ORB keypoints of one rendered SyntheticWorld stereo pair (600
per eye, extracted by the port, `_torch_parity.rendered_pair`), with
projected points made from them by seeded numpy noise, plus rows placed
exactly at |dv| == r (and |du| == r) from a candidate and one float32 ulp
beyond.

Stated tolerances: the int32 indices, distances and validity exact; the
float32 `u_right` and `depth` of stereo_match within 1 ulp (`bf /
disparity` takes bf as a float64 scalar in JAX and a float32 tensor in the
port).
"""

import numpy as np
import pytest
from _torch_parity import flip_bits, jax_and_torch, matcher_pair, np_of, on_boundary, projected

from orbslam2_tpu.ops import matchers as jmatch
from orbslam2_tpu_torch.ops import matchers as tmatch

SF = (1.2 ** np.arange(8)).astype(np.float32)


@pytest.fixture(scope="module")
def pair():
    return matcher_pair()


def test_stereo_match(pair):
    world, (L, R) = pair
    rng = np.random.default_rng(20)
    uvL, octL, descL, validL = L["uv"].copy(), L["oct"].copy(), L["desc"].copy(), L["valid"].copy()
    # the last 40 left slots: octave-0 rows (band 2.0) on the band's edge
    # of a right keypoint of octave <= 1, 3 px of disparity
    k = 40
    cols, v = on_boundary(rng, R["uv"][:, 1], np.nonzero(R["valid"] & (R["oct"] <= 1))[0], 2.0, k)
    uvL[-k:] = np.stack([R["uv"][cols, 0] + 3.0, v], axis=1)
    octL[-k:] = 0
    descL[-k:] = flip_bits(rng, R["desc"][cols], 0.1)
    validL[-k:] = True
    args = (uvL, octL, descL, validL, R["uv"], R["oct"], R["desc"], R["valid"], SF)
    j, t = jax_and_torch(jmatch.stereo_match, tmatch.stereo_match, args, (2, 6), world.bf, world.baseline)
    np.testing.assert_array_equal(np_of(t.valid), np_of(j.valid))
    for name in ("u_right", "depth"):
        np.testing.assert_array_max_ulp(np_of(getattr(t, name)), np_of(getattr(j, name)), maxulp=1)
    assert np_of(t.valid).sum() > 200 and np_of(t.valid)[-k:].any()


@pytest.mark.parametrize("gating", ["forward", "backward", "neither"])
def test_search_by_projection_frame(pair, gating):
    _, (cur, _) = pair
    rng = np.random.default_rng(21)
    M, th, k = 500, 7.0, 40
    pick, uv, octv, desc = projected(rng, cur, M)
    # octave-0 rows (window 7.0) on the window's edge of an octave-0
    # keypoint: in v (first k), in u (next k); half of each one ulp beyond
    cols0 = np.nonzero(cur["valid"] & (cur["oct"] == 0))[0]
    cols, v = on_boundary(rng, cur["uv"][:, 1], cols0, th, k)
    uv[:k] = np.stack([cur["uv"][cols, 0], v], axis=1)
    desc[:k] = cur["desc"][cols]
    cols2, u = on_boundary(rng, cur["uv"][:, 0], cols0, th, k)
    uv[k:2 * k] = np.stack([u, cur["uv"][cols2, 1]], axis=1)
    desc[k:2 * k] = cur["desc"][cols2]
    octv[:2 * k] = 0
    pick[:2 * k] = np.concatenate([cols, cols2])
    valid = rng.uniform(size=M) < 0.9
    angle = (cur["angle"][pick] + rng.normal(0, 0.05, M)).astype(np.float32)
    args = (cur["uv"], cur["oct"], cur["desc"], cur["valid"], cur["angle"], uv, octv, desc, valid, angle, SF)
    fwd, bwd = gating == "forward", gating == "backward"
    (pj, dj), (pt, dt) = jax_and_torch(jmatch.search_by_projection_frame, tmatch.search_by_projection_frame,
                              args, (2, 7), th, fwd, bwd)
    np.testing.assert_array_equal(np_of(pt), np_of(pj))
    np.testing.assert_array_equal(np_of(dt), np_of(dj))
    assert (np_of(pt) >= 0).sum() > 100
