"""The fixed-order segment sum (`ops/ba.py::segment_sum`) that the local
and global BAs and the essential graph use in place of float `index_add_`,
on the CPU.

Stated tolerances: against `index_add_` on random indices with empty
segments and dropped entries, within 1e-6 (fp32) and 1e-12 (float64) of
each segment's sum of magnitudes: the two add in different orders, and a
sum's rounding error grows with that sum; repeated calls give identical
bits. The card's run-to-run check is chip_smoke.py's reproducibility
phase.
"""

import numpy as np
import pytest
import torch

from orbslam2_tpu_torch.ops import ba


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-6), (torch.float64, 1e-12)])
@pytest.mark.parametrize("inner", [(6,), (6, 6), ()])
def test_segment_sum_equals_index_add(dtype, tol, inner):
    rng = np.random.default_rng(7)
    K, E = 50, 4000
    # 30 of the 50 segments hold entries, unevenly; the rest are empty; a
    # tenth of the entries are left out
    used = rng.choice(K, 30, replace=False)
    idx = torch.from_numpy(used[rng.zipf(1.5, E) % 30])
    keep = torch.from_numpy(rng.uniform(size=E) < 0.9)
    x = torch.from_numpy(rng.normal(size=(E, *inner))).to(dtype)
    seg = ba.segments(idx, K, keep)
    got = ba.segment_sum(seg, x)
    kept = torch.where(keep.reshape(-1, *[1] * len(inner)), x, 0)
    want = torch.zeros((K, *inner), dtype=dtype).index_add_(0, idx, kept)
    scale = torch.zeros((K, *inner), dtype=torch.float64).index_add_(0, idx, kept.double().abs())
    assert got.shape == want.shape and got.dtype == dtype
    assert float(((got - want).abs().double() / scale.clamp(min=1e-30)).max()) <= tol
    empty = torch.ones(K, dtype=torch.bool)
    empty[torch.from_numpy(used)] = False
    assert torch.all(got[empty] == 0)
    counts = torch.bincount(idx[keep], minlength=K)
    assert seg.offsets.tolist() == [0] + torch.cumsum(counts, 0).tolist()
    assert torch.equal(idx[seg.order], torch.sort(idx[keep], stable=True).values)
    for _ in range(3):
        assert torch.equal(ba.segment_sum(seg, x), got)


def test_segments_of_a_ba_problem():
    """`camera_segments` lists each camera's valid [P, D] slots in slot
    order, camera by camera."""
    obs_kf = torch.tensor([[2, 0, 2], [1, 2, 0]])
    valid = torch.tensor([[True, True, True], [True, True, False]])
    prob = ba.BAProblemPM(poses=torch.zeros(4, 4, 4), points=torch.zeros(2, 3), obs_kf=obs_kf,
                          obs=torch.zeros(2, 3, 3), inv_sigma2=torch.ones(2, 3),
                          is_stereo=torch.zeros(2, 3, dtype=torch.bool), edge_valid=valid,
                          pose_fixed=torch.zeros(4, dtype=torch.bool))
    seg = ba.camera_segments(prob)
    assert seg.order.tolist() == [1, 3, 0, 2, 4] and seg.offsets.tolist() == [0, 1, 2, 5, 5]
