"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: they need a CUDA card and nvcc, and skip where there is
none (a CUDA kernel has no interpret mode). On the card:

    python -m pytest tests/test_torch_kernels.py -m cuda

Stated tolerances: K2 (fast_nms), K3 (hamming_best2, every mode, `fuse`
included), K4 (bow_transform) and K6 (select_keypoints) exact; K5
(pose_lm) with the plain version's inlier masks and counts and the pose
within 1e-6 (the float64 sums run in another order, and the pose is
rounded to float32); K1
(orb_patch_desc) angle within 1e-4 rad and descriptor bit error rate < 1%
(the kernel sums the moments in another order than the plain version's
matrix product, so an angle can move in its last bits and, rarely, a
rotation bin flip).
"""

import os

import numpy as np
import pytest
import torch
from _torch_parity import slam_config

from orbslam2_tpu_torch import config as torch_config
from orbslam2_tpu_torch.datasets.synthetic import SyntheticWorld
from orbslam2_tpu_torch.kernels import cases
from orbslam2_tpu_torch.ops import fast, hamming, matchers, orb, patches, pose_opt
from orbslam2_tpu_torch.slam.system import System

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


def _k1_close(got, want):
    (a, d), (a0, d0) = got, want
    dang = torch.remainder(a.double() - a0.double() + np.pi, 2 * np.pi) - np.pi
    assert float(dang.abs().max()) <= 1e-4
    flips = (d ^ d0).cpu().numpy().view(np.uint8)
    assert np.unpackbits(flips).mean() < 0.01


def test_fast_nms_exact(levels):
    for img, _, _ in levels:
        assert torch.equal(fast.fast_nms(img), fast.fast_nms_plain(img))


def test_orb_patch_desc(levels):
    for img, xs, ys in levels:
        _k1_close(patches.orb_patch_desc(img, xs, ys), patches.orb_patch_desc_plain(img, xs, ys))


def test_fast_nms_levels_exact(levels):
    imgs = [img for img, _, _ in levels]
    got = fast.fast_nms_levels(imgs)
    assert len(got) == 8 and got[0].shape == (2, 480, 752)
    for g, img in zip(got, imgs):
        assert torch.equal(g, fast.fast_nms_plain(img))


def test_orb_patch_desc_levels(levels):
    args = [list(col) for col in zip(*levels)]
    got = patches.orb_patch_desc_levels(*args)
    assert got[0].shape == (2, 1200) and got[1].shape == (2, 1200, 8)
    _k1_close(got, patches.orb_patch_desc_levels_plain(*args))
    offset = 0
    for img, xs, ys in levels:
        n = xs.shape[1]
        _k1_close((got[0][:, offset:offset + n], got[1][:, offset:offset + n]),
                  patches.orb_patch_desc_plain(img, xs, ys))
        offset += n


def test_orb_patch_desc_levels_border_and_clamped(levels):
    """Keypoints on the 16 px border, where the window reaches 5 px into
    the reflection, and far outside it, where the window start is clamped."""
    imgs, xs_l, ys_l = [], [], []
    for img, _, _ in levels:
        h, w = img.shape[1], img.shape[2]
        b = orb.KP_BORDER
        xs = [b, w - 1 - b, b, w - 1 - b, w // 2, -60, 0, w - 1, w + 40, 3]
        ys = [b, b, h - 1 - b, h - 1 - b, b, h // 2, -9, h - 1, h + 40, 2]
        imgs.append(img)
        xs_l.append(torch.tensor([xs, xs[::-1]], dtype=torch.int32, device=img.device))
        ys_l.append(torch.tensor([ys, ys[::-1]], dtype=torch.int32, device=img.device))
    _k1_close(patches.orb_patch_desc_levels(imgs, xs_l, ys_l),
              patches.orb_patch_desc_levels_plain(imgs, xs_l, ys_l))


def test_levels_without_work(levels):
    """The launchers lay out the grid: a level with no keypoints takes no
    slot or block, and a call with no work launches nothing."""
    imgs, xs_l, ys_l = [list(col) for col in zip(*levels)]
    none = torch.zeros((2, 0), dtype=torch.int32, device=imgs[0].device)
    xs_l[2], ys_l[2] = none, none
    got = patches.orb_patch_desc_levels(imgs, xs_l, ys_l)
    assert got[0].shape == (2, 1200 - levels[2][1].shape[1])
    _k1_close(got, patches.orb_patch_desc_levels_plain(imgs, xs_l, ys_l))
    before = (fast.fast_nms_levels.launches, patches.orb_patch_desc_levels.launches)
    a, d = patches.orb_patch_desc_levels(imgs[:3], [none] * 3, [none] * 3)
    assert a.shape == (2, 0) and d.shape == (2, 0, 8)
    assert fast.fast_nms_levels([imgs[0][:0]])[0].shape == (0, 480, 752)
    assert (fast.fast_nms_levels.launches, patches.orb_patch_desc_levels.launches) == before


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


@pytest.fixture(scope="module")
def k3_cases(cuda):
    return cases.k3_cases(cuda)


@pytest.mark.parametrize("mode", ["stereo", "frame", "points", "fuse", "mask", "nodes"])
def test_hamming_best2_modes_on_edge_cases(k3_cases, mode):
    """Each K3 mode equals its plain version (gate + best2_plain) on the
    boundary, complement, empty, non-finite and tie-heavy cases (nodes:
    rows whose node no column holds, node -1, every column in one node,
    invalid rows and columns, ties, N == 1, M == 0, 12000 columns)."""
    n = 0
    for name, A, B, gate in k3_cases:
        if name.split()[0].split("/")[0] != mode:
            continue
        got, want = cases.k3(A, B, gate), cases.k3_plain(A, B, gate)
        for g, w in zip(got, want):
            assert torch.equal(g, w), name
        n += 1
    assert n >= 2


def test_fused_frames_build_no_dense_gate(cuda, monkeypatch):
    """On the card the fused frame's three matchers go through the gated K3
    modes: with every plain [N, M] gate and distance builder of
    `hamming` patched to raise, fused frames still track and map, with one
    stereo and one points launch each and no mask launch from the tracker
    (search_by_bow). The mapper, inline on keyframe frames, launches K3
    `fuse` and, for epipolar_match, `mask` mode on a gate it builds itself:
    its mask launches are counted apart, under `epipolar_match`."""
    world = SyntheticWorld(n_points=900, seed=7, baseline=0.2)
    _, frames = world.render_sequence(6, step=0.06)
    system = System(None, slam_config(world, torch_config), device=cuda)
    for i in range(3):
        system.track_stereo(*frames[i], timestamp=i / 20.0)

    def refuse(*args, **kwargs):
        raise AssertionError("a dense [N, M] gate or distance matrix was built on the CUDA path")

    for name in ("gate_mask", "best2_plain", "best2_gated_plain", "masked_hamming", "hamming_matrix"):
        monkeypatch.setattr(hamming, name, refuse)
    mask0, gated0 = dict(hamming.best2.launches), dict(hamming.best2_gated.launches)
    for i in range(3, 6):
        assert system.tracker._can_fuse()
        assert system.track_stereo(*frames[i], timestamp=i / 20.0) is not None
    gated = {k: v - gated0[k] for k, v in hamming.best2_gated.launches.items()}
    assert hamming.best2.launches["search_by_bow"] == mask0["search_by_bow"]
    assert gated["stereo"] == 3 and gated["points"] == 3 and gated["frame"] >= 3


def test_nodes_mode_counts_under_its_caller(cuda):
    """search_by_bow_nodes launches K3 `nodes` once per call with rows,
    counted under `nodes:loop`, and agrees with its plain version there."""
    for name, A, B, g in cases.k3_cases(cuda):
        # M == 0 has no column to take an angle from
        if not (isinstance(g, hamming.Gate) and g.mode == "nodes" and B.shape[0] > 0):
            continue
        angles = [torch.zeros(t.shape[0], device=cuda) for t in (A, B)]
        args = (A, g.row_valid, angles[0], g.row_node, B, g.col_valid, angles[1], g.col_node, 0.75)
        before = hamming.best2_gated.launches["nodes:loop"]
        got = matchers.search_by_bow_nodes(*args)
        assert hamming.best2_gated.launches["nodes:loop"] == before + (A.shape[0] > 0), name
        want = matchers.search_by_bow_nodes(*(a.cpu() if isinstance(a, torch.Tensor) else a for a in args))
        for x, y in zip(got, want):
            assert torch.equal(x.cpu(), y), name


def test_wrappers_count_launches(levels):
    img, xs, ys = levels[3]
    before = (fast.fast_nms_levels.launches, patches.orb_patch_desc_levels.launches,
              hamming.best2.launches["search_by_bow"])
    gated0 = dict(hamming.best2_gated.launches)
    fast.fast_nms(img)
    patches.orb_patch_desc(img, xs, ys)
    d = torch.zeros((4, 8), dtype=torch.int32, device=img.device)
    hamming.best2(d, d, torch.ones((4, 4), dtype=torch.bool, device=img.device))
    after = (fast.fast_nms_levels.launches, patches.orb_patch_desc_levels.launches,
             hamming.best2.launches["search_by_bow"])
    assert [a - b for a, b in zip(after, before)] == [1, 1, 1]
    for name, A, B, gate in cases.k3_cases(img.device)[:1]:
        cases.k3(A, B, gate)
        assert hamming.best2_gated.launches[gate.mode] == gated0[gate.mode] + 1
    hamming.best2(d[:0], d, torch.ones((0, 4), dtype=torch.bool, device=img.device))  # no rows: no launch
    assert hamming.best2.launches["search_by_bow"] == after[2]


def test_all_level_calls_count_one_launch(levels):
    imgs, xs_l, ys_l = [list(col) for col in zip(*levels)]
    before = (fast.fast_nms_levels.launches, patches.orb_patch_desc_levels.launches)
    fast.fast_nms_levels(imgs)
    patches.orb_patch_desc_levels(imgs, xs_l, ys_l)
    after = (fast.fast_nms_levels.launches, patches.orb_patch_desc_levels.launches)
    assert [a - b for a, b in zip(after, before)] == [1, 1]


def test_bow_transform_exact(cuda):
    """K4 equals its plain version on the edge cases of `kernels/cases.py`
    (ragged tree with ties at every level, k = 40, N == 0) and on a frame's
    descriptors against the generic vocabulary; it counts one launch per
    call with descriptors and none for N == 0."""
    from orbslam2_tpu_torch.vocab import bow

    for name, voc, desc, valid, level in cases.k4_cases(cuda):
        before = bow.transform_words_nodes.launches
        got = bow.transform_words_nodes(voc, desc, valid, level)
        want = bow.transform_words_nodes_plain(voc, desc, valid, level)
        for g, w in zip(got, want):
            assert torch.equal(g, w), name
        assert bow.transform_words_nodes.launches == before + (desc.shape[0] > 0), name
    voc = bow.load_npz(os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "assets",
                                    "vocab_generic.npz"), cuda)
    world = SyntheticWorld(n_points=900, seed=7, baseline=0.2)
    imL, imR = world.render_stereo(world.trajectory(1)[0])
    f = orb.extract(torch.from_numpy(np.stack([imL, imR])).round().to(cuda), orb.OrbParams())
    for e in (0, 1):
        got = bow.transform_words_nodes(voc, f.desc[e], f.valid[e])
        want = bow.transform_words_nodes_plain(voc, f.desc[e], f.valid[e])
        for g, w in zip(got, want):
            assert torch.equal(g, w)


def _k5_same(got, want, what):
    assert torch.equal(got.inlier, want.inlier), what
    assert int(got.n_inliers) == int(want.n_inliers), what
    assert float((got.Tcw - want.Tcw).abs().max()) <= 1e-6, what


def test_pose_lm_matches_plain(cuda):
    """K5 against its plain version on the edge cases of `kernels/cases.py`
    and on a problem made from an extracted frame (its stereo keypoints
    back-projected at a known pose, T0 moved off it, every fifth match
    moved 40 px), one launch per call."""
    for name, args, cam in cases.k5_cases(cuda):
        before = pose_opt.pose_optimize.launches
        got = pose_opt.pose_optimize(*args, cam)
        assert pose_opt.pose_optimize.launches == before + 1, name
        _k5_same(got, pose_opt.pose_optimize_plain(*args, cam), name)
    world = SyntheticWorld(n_points=900, seed=7, baseline=0.2)
    system = System(None, slam_config(world, torch_config), device="cuda")
    cam = system.frontend.camera
    f = system.frontend.process(*world.render_stereo(world.trajectory(1)[0]))
    stereo = f.u_right >= 0
    z = torch.where(stereo, f.depth, 5.0)
    pc = torch.stack([(f.uv[:, 0] - cam.cx) * z / cam.fx, (f.uv[:, 1] - cam.cy) * z / cam.fy, z], dim=-1)
    obs = torch.cat([f.uv, f.u_right[:, None]], dim=1).contiguous()
    obs[::5, :2] += 40.0
    T0 = torch.eye(4, device=cuda)
    T0[:3, 3] = torch.tensor([0.05, -0.03, 0.08], device=cuda)
    inv_sig = torch.ones_like(z)
    args = (T0, pc.contiguous(), obs, inv_sig, stereo, f.valid)
    _k5_same(pose_opt.pose_optimize(*args, cam), pose_opt.pose_optimize_plain(*args, cam), "extracted frame")


def test_pose_lm_cluster_cases(cuda):
    """K5's cluster layout (`kernels/cases.py::k5_cluster_cases`: N = 0,
    N < 32, N that the CTAs' slices do not divide, every edge an outlier,
    an indefinite H, NaN pivots, small-angle steps) against its plain
    version, one launch per call, and a second launch on the same
    arguments equal to the first bit for bit (fixed-order sums)."""
    for name, args, cam in cases.k5_cluster_cases(cuda):
        before = pose_opt.pose_optimize.launches
        got = pose_opt.pose_optimize(*args, cam)
        again = pose_opt.pose_optimize(*args, cam)
        assert pose_opt.pose_optimize.launches == before + 2, name
        _k5_same(got, pose_opt.pose_optimize_plain(*args, cam), name)
        for a, b in zip(got, again):
            assert torch.equal(a, b), name


def test_select_keypoints_block_cases(cuda):
    """K6's block layout (`kernels/cases.py::k6_block_cases`: one grid
    cell, ragged cells, all zeros, all hi, a budget above the candidates,
    grid cells wider than a chunk, best keys where bands and chunks meet)
    exactly against its plain version, two launches per call."""
    for name, scores, budgets in cases.k6_block_cases(cuda):
        before = orb.select_keypoints_levels.launches
        got = orb.select_keypoints_levels(scores, budgets, 20.0, 7.0)
        assert orb.select_keypoints_levels.launches == before + 2, name
        want = orb.select_keypoints_levels_plain(scores, budgets, 20.0, 7.0)
        for g, w in zip(got, want):
            assert all(torch.equal(a, b) for a, b in zip(g, w)), name


def test_select_keypoints_exact(levels):
    """K6 equals its plain version on the edge cases of `kernels/cases.py`
    and on the 8 levels of a rendered stereo pair (K2's scores), with two
    launches (cell pass, top-k pass) per call."""
    dev = levels[0][0].device
    frame = ("rendered frame", fast.fast_nms_levels([img for img, _, _ in levels]),
             orb.features_per_level(orb.OrbParams()))
    for name, scores, budgets in cases.k6_cases(dev) + [frame]:
        before = orb.select_keypoints_levels.launches
        got = orb.select_keypoints_levels(scores, budgets, 20.0, 7.0)
        assert orb.select_keypoints_levels.launches == before + 2, name
        want = orb.select_keypoints_levels_plain(scores, budgets, 20.0, 7.0)
        for g, w in zip(got, want):
            assert all(torch.equal(a, b) for a, b in zip(g, w)), name
    # the extractor's keypoints are the plain selection's
    for lvl, (img, xs, ys) in enumerate(levels):
        assert torch.equal(got[0][lvl], xs) and torch.equal(got[1][lvl], ys)
