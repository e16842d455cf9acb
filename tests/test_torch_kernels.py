"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: they need a CUDA card and nvcc, and skip where there is
none (a CUDA kernel has no interpret mode). On the card:

    python -m pytest tests/test_torch_kernels.py -m cuda

Stated tolerances: K2 (fast_nms) and K3 (hamming_best2) exact; K1
(orb_patch_desc) angle within 1e-4 rad and descriptor bit error rate < 1%.
"""

import numpy as np
import pytest
import torch

from orbslam2_tpu_torch.datasets.synthetic import SyntheticWorld
from orbslam2_tpu_torch.ops import fast, hamming, orb, patches

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(scope="module")
def levels(cuda):
    world = SyntheticWorld(n_points=900, seed=7, baseline=0.2)
    imL, imR = world.render_stereo(world.trajectory(3, step=0.06)[2])
    img = torch.from_numpy(np.stack([imL, imR])).round().to(cuda)
    params = orb.OrbParams()
    out = []
    for lvl, (h, w) in enumerate(orb.level_sizes(480, 752, params)):
        if lvl > 0:
            img = orb.pyramid_level(img, (h, w))
        s = fast.fast_nms_plain(img)
        xs, ys, _, valid = orb._select_level_keypoints(
            s, orb.features_per_level(params)[lvl], params.ini_th, params.min_th)
        out.append((img, torch.where(valid, xs, orb.KP_BORDER), torch.where(valid, ys, orb.KP_BORDER)))
    return out


def test_fast_nms_exact(levels):
    for img, _, _ in levels:
        assert torch.equal(fast.fast_nms(img), fast.fast_nms_plain(img))


def test_orb_patch_desc(levels):
    for img, xs, ys in levels:
        a, d = patches.orb_patch_desc(img, xs, ys)
        a0, d0 = patches.orb_patch_desc_plain(img, xs, ys)
        dang = torch.remainder(a.double() - a0.double() + np.pi, 2 * np.pi) - np.pi
        assert float(dang.abs().max()) <= 1e-4
        flips = (d ^ d0).cpu().numpy().view(np.uint8)
        assert np.unpackbits(flips).mean() < 0.01


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("shape", [(1200, 1200), (1, 1), (37, 513)])
def test_hamming_best2_exact(cuda, shape, ties):
    N, M = shape
    gen = torch.Generator(device=cuda).manual_seed(N * 7 + M)
    if ties:
        pool = torch.tensor([0, 1, 3, -1, -2**31], dtype=torch.int32, device=cuda)
        words = pool[torch.randint(0, 5, (N + M, 8), generator=gen, device=cuda)]
    else:
        words = torch.randint(-2**31, 2**31 - 1, (N + M, 8), generator=gen, device=cuda,
                              dtype=torch.int64).to(torch.int32)
    mask = torch.rand((N, M), generator=gen, device=cuda) < 0.2
    mask[: max(N // 8, 1) - 1] = False
    got = hamming.best2(words[:N], words[N:], mask)
    want = hamming.best2_plain(words[:N], words[N:], mask)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_wrappers_count_launches(levels):
    img, xs, ys = levels[3]
    before = (fast.fast_nms.launches, patches.orb_patch_desc.launches, hamming.best2.launches)
    fast.fast_nms(img)
    patches.orb_patch_desc(img, xs, ys)
    d = torch.zeros((4, 8), dtype=torch.int32, device=img.device)
    hamming.best2(d, d, torch.ones((4, 4), dtype=torch.bool, device=img.device))
    after = (fast.fast_nms.launches, patches.orb_patch_desc.launches, hamming.best2.launches)
    assert [a - b for a, b in zip(after, before)] == [1, 1, 1]
