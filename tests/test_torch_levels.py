"""The extractor's all-level entry points against the per-level plain
functions, on the CPU at 120x160 with 4 pyramid levels.

`fast.fast_nms_levels` and `patches.orb_patch_desc_levels` serve every
level of a frame with one kernel launch on the card; on CPU tensors they
run their plain versions, which these tests hold to the per-level plain
calls bit for bit, including a level with no keypoints and keypoints on
and outside the extractor's border (the clamped window). The reflect
index that the K1 kernel computes in place of a padded copy of the level
is held to `F.pad(mode="reflect")`. `orb.extract` against the JAX
package is `tests/test_torch_frontend.py`.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from _torch_parity import np_of

from orbslam2_tpu_torch.ops import fast, orb, patches

H, W = 120, 160
PARAMS = orb.OrbParams(n_features=3, n_levels=4)  # budgets [1, 1, 1, 0]


def _images(seed=0):
    rng = np.random.default_rng(seed)
    img = np.kron(rng.uniform(0, 255, (2, H // 8, W // 8)), np.ones((8, 8)))
    img = np.clip(img + rng.normal(0, 12, img.shape), 0, 255)
    return torch.from_numpy(np.rint(img).astype(np.float32))


@pytest.fixture(scope="module")
def pyramid():
    levels = [_images()]
    for size in orb.level_sizes(H, W, PARAMS)[1:]:
        levels.append(orb.pyramid_level(levels[-1], size))
    return levels


def _keypoints(rng, h, w, n):
    """n keypoints per eye: random inside the 16 px border, plus (when n
    allows) the four border corners and points outside it."""
    xs = rng.integers(orb.KP_BORDER, w - orb.KP_BORDER, (2, n))
    ys = rng.integers(orb.KP_BORDER, h - orb.KP_BORDER, (2, n))
    edge_x = [orb.KP_BORDER, w - 1 - orb.KP_BORDER, -40, 0, w - 1, w + 30]
    edge_y = [orb.KP_BORDER, h - 1 - orb.KP_BORDER, 5, -3, h + 2, h - 1]
    k = min(n, len(edge_x))
    xs[:, :k], ys[:, :k] = edge_x[:k], edge_y[:k]
    return torch.from_numpy(xs.astype(np.int32)), torch.from_numpy(ys.astype(np.int32))


def test_budgets_have_a_zero_level():
    assert orb.features_per_level(PARAMS) == [1, 1, 1, 0]


def test_fast_nms_levels_equal_per_level(pyramid):
    got = fast.fast_nms_levels(pyramid)
    assert len(got) == len(pyramid)
    for g, img in zip(got, pyramid):
        assert torch.equal(g, fast.fast_nms_plain(img))
    assert sum(int((g > 0).sum()) for g in got) > 50
    assert torch.equal(fast.fast_nms(pyramid[2]), got[2])


def test_orb_patch_desc_levels_equal_per_level(pyramid):
    rng = np.random.default_rng(1)
    counts = [9, 6, 0, 7]  # level 2 has no keypoints
    kps = [_keypoints(rng, img.shape[1], img.shape[2], n) for img, n in zip(pyramid, counts)]
    xs_l, ys_l = [k[0] for k in kps], [k[1] for k in kps]
    angle, desc = patches.orb_patch_desc_levels(pyramid, xs_l, ys_l)
    assert angle.shape == (2, sum(counts)) and desc.shape == (2, sum(counts), 8)
    offset = 0
    for img, xs, ys, n in zip(pyramid, xs_l, ys_l, counts):
        a0, d0 = patches.orb_patch_desc_plain(img, xs, ys)
        assert torch.equal(angle[:, offset:offset + n], a0)
        assert torch.equal(desc[:, offset:offset + n], d0)
        offset += n
    a1, d1 = patches.orb_patch_desc(pyramid[1], xs_l[1], ys_l[1])
    assert torch.equal(a1, angle[:, 9:15]) and torch.equal(d1, desc[:, 9:15])


def test_window_index_reads_the_padded_window(pyramid):
    """The kernel's indexing (window start clamped in padded coordinates,
    then reflected into the level) reads what `extract_patches` reads from
    the padded level, for keypoints on and outside the border too."""
    rng = np.random.default_rng(2)
    for img in pyramid:
        xs, ys = _keypoints(rng, img.shape[1], img.shape[2], 8)
        got = img.reshape(-1)[patches.window_index(img.shape, xs, ys)]
        want = patches.extract_patches(patches.pad_level(img), xs, ys)
        assert torch.equal(got, want)


@pytest.mark.parametrize("n", [49, 60, 97])
def test_reflect_index_matches_pad(n):
    """Every row and column of a 48 px reflected overhang."""
    img = torch.arange(n * (n + 3), dtype=torch.float64).reshape(1, n, n + 3)
    want = F.pad(img[:, None], (48, 48, 48, 48), mode="reflect")[0, 0]
    rows = patches.reflect_index(torch.arange(-48, n + 48), n)
    cols = patches.reflect_index(torch.arange(-48, n + 3 + 48), n + 3)
    assert torch.equal(img[0][rows][:, cols], want)


def test_extract_stages_equal_per_level_loop(pyramid):
    """The three-stage extractor (pyramid, one K2 call, selection, one K1
    call) gives what a level-by-level loop of the plain functions gives,
    with the zero-budget level skipped."""
    f = orb.extract(pyramid[0], PARAMS)
    sf = orb.scale_factors(PARAMS)
    want = {k: [] for k in ("uv", "octave", "angle", "response", "desc", "valid")}
    for lvl, n_t in enumerate(orb.features_per_level(PARAMS)):
        if n_t == 0:
            continue
        img = pyramid[lvl]
        xs, ys, resp, valid = orb._select_level_keypoints(
            fast.fast_nms_plain(img), n_t, PARAMS.ini_th, PARAMS.min_th)
        xs = torch.where(valid, xs, orb.KP_BORDER)
        ys = torch.where(valid, ys, orb.KP_BORDER)
        ang, desc = patches.orb_patch_desc_plain(img, xs, ys)
        scale = torch.tensor(sf[lvl], dtype=torch.float32)
        want["uv"].append(torch.stack([xs * scale, ys * scale], dim=-1))
        want["octave"].append(torch.full((2, n_t), lvl, dtype=torch.int32))
        for k, v in (("angle", ang), ("response", resp), ("desc", desc), ("valid", valid)):
            want[k].append(v)
    for k, parts in want.items():
        np.testing.assert_array_equal(np_of(getattr(f, k)), np_of(torch.cat(parts, dim=1)), err_msg=k)
    assert f.valid.all()


def test_level_count_is_checked(pyramid):
    with pytest.raises(ValueError):
        fast.fast_nms_levels([])
    with pytest.raises(ValueError):
        fast.fast_nms_levels(pyramid * 5)
    xs = torch.zeros((2, 1), dtype=torch.int32)
    with pytest.raises(ValueError):
        patches.orb_patch_desc_levels(pyramid * 5, [xs] * 20, [xs] * 20)
    with pytest.raises(ValueError):
        patches.orb_patch_desc_levels(pyramid, [xs], [xs])
