"""Parity of the PyTorch port's matcher building blocks against the JAX
package: collision resolution, the rotation consistency mask and
search_by_projection_points, exact.
"""

import numpy as np
from _torch_parity import both, desc_both, np_of, random_descs

from orbslam2_tpu.ops import hamming as jham
from orbslam2_tpu.ops import matchers as jmatch
from orbslam2_tpu_torch.ops import matchers as tmatch


class TestMatcherBlocks:
    def test_resolve_collisions(self):
        rng = np.random.default_rng(8)
        idx = rng.integers(0, 30, 200).astype(np.int32)
        d = rng.integers(0, 60, 200).astype(np.int32)
        d[rng.uniform(size=200) < 0.3] = jham.MAX_DIST
        (ji, ti), (jd, td) = both(idx), both(d)
        for t, j in zip(tmatch._resolve_collisions(ti, td, 40), jmatch._resolve_collisions(ji, jd, 40)):
            np.testing.assert_array_equal(np_of(t), np_of(j))

    def test_rotation_consistency(self):
        rng = np.random.default_rng(9)
        a = rng.uniform(-np.pi, np.pi, 300).astype(np.float32)
        b = (a - 0.3 + rng.normal(0, 0.05, 300)).astype(np.float32)
        b[:60] = rng.uniform(-np.pi, np.pi, 60)
        valid = rng.uniform(size=300) < 0.9
        args = [both(x) for x in (a, b, valid)]
        t = tmatch.rotation_consistency_mask(*[x[1] for x in args])
        j = jmatch.rotation_consistency_mask(*[x[0] for x in args])
        np.testing.assert_array_equal(np_of(t), np_of(j))

    def test_search_by_projection_points(self):
        rng = np.random.default_rng(10)
        N, P = 300, 256
        uv = rng.uniform([0, 0], [752, 480], (N, 2)).astype(np.float32)
        octv = rng.integers(0, 8, N).astype(np.int32)
        ur = np.where(rng.uniform(size=N) < 0.7, uv[:, 0] - 10.0, -1.0).astype(np.float32)
        desc = random_descs(rng, N)
        pick = rng.integers(0, N, P)
        uv_pt = (uv[pick] + rng.normal(0, 2.0, (P, 2))).astype(np.float32)
        ur_pt = (uv_pt[:, 0] - 10.0).astype(np.float32)
        lvl = np.clip(octv[pick] + rng.integers(0, 2, P), 0, 7).astype(np.int32)
        vcos = rng.uniform(0.9, 1.0, P).astype(np.float32)
        dpt = desc[pick].copy()
        flips = rng.integers(0, 32, (P, 8)).astype(np.uint32)
        dpt ^= (np.uint32(1) << flips) * (rng.uniform(size=(P, 8)) < 0.5)
        vcur = rng.uniform(size=N) < 0.9
        vpt = rng.uniform(size=P) < 0.9
        sf = (1.2 ** np.arange(8)).astype(np.float32)
        args_np = (uv, octv, ur, desc, vcur, uv_pt, ur_pt, lvl, vcos, dpt, vpt, sf)
        jargs, targs = [], []
        for i, a in enumerate(args_np):
            j, t = desc_both(a) if i in (3, 9) else both(a)
            jargs.append(j)
            targs.append(t)
        pj, dj = jmatch.search_by_projection_points(*jargs, 1.0)
        pt, dt = tmatch.search_by_projection_points(*targs, 1.0)
        np.testing.assert_array_equal(np_of(pt), np_of(pj))
        np.testing.assert_array_equal(np_of(dt), np_of(dj))
        assert (np_of(pt) >= 0).sum() > 50
