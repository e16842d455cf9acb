"""Data association: stereo matching, projection matching, BoW-style
matching, rotation-consistency filtering.

Port of the parts of orbslam2_tpu/ops/matchers.py that the stereo
tracking, local mapping and loop closing paths call (reference
src/ORBmatcher.cpp). Each matcher is a gated all-pairs problem: it
computes the per-row parts of its geometric gate (band or window
half-size; the vocabulary node in `search_by_bow_nodes`) with the plain
expressions, and kernel K3 (`hamming.best2_gated`) takes the gated Hamming
best and second best per row, evaluating the pairwise gate itself on a
CUDA tensor; on a CPU tensor the gate is the plain [N, M] mask of
`hamming.gate_mask`. `search_by_bow` and `epipolar_match` keep a plain
mask (`hamming.best2`): the epipolar line crosses the image, so a v band
would prune nothing there.

The JAX package's one-hot matmuls that stood in for gathers and scatters
on the TPU (`_choice_matrix`, `_fetch`, `lookup_level`) are plain indexing
here, with the same choices: the lowest index wins an argmin tie and the
best distance, then the lowest source index, wins a collision.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from . import hamming

HISTO_BINS = 30  # rotation histogram bins (reference ORBmatcher HISTO_LENGTH)
TWO_PI = 6.283185307179586


def _resolve_collisions(best_idx: torch.Tensor, d_eff: torch.Tensor, n: int):
    """Sources s claim targets best_idx[s] with score d_eff[s] (MAX_DIST =
    no claim); keep the best claim per target, ties to the lowest source.
    Returns (src_for_target [n] int32, -1 where unclaimed; best_d [n])."""
    INF = hamming.MAX_DIST
    S = best_idx.shape[0]
    key = d_eff.to(torch.int64) * S + torch.arange(S, device=d_eff.device)
    out = torch.full((n,), INF * S, dtype=torch.int64, device=d_eff.device)
    out = out.scatter_reduce(0, best_idx.to(torch.int64), key, reduce="amin")
    best_d = torch.div(out, S, rounding_mode="floor")
    src = torch.where(best_d < INF, out - best_d * S, -1)
    return src.to(torch.int32), best_d.to(torch.int32)


def rotation_consistency_mask(
    angle_a: torch.Tensor, angle_b: torch.Tensor, match_valid: torch.Tensor
) -> torch.Tensor:
    """Keep matches whose angle difference falls in the 3 dominant
    histogram bins, bins 2/3 only above 0.1x the first (reference
    ComputeThreeMaxima, ORBmatcher.cpp:1446-1487)."""
    rot = torch.remainder(angle_a - angle_b, TWO_PI)
    bins = torch.remainder(torch.round(rot * (HISTO_BINS / TWO_PI)).to(torch.int32), HISTO_BINS)
    hist = torch.zeros(HISTO_BINS, dtype=torch.int32, device=bins.device)
    hist = hist.index_add(0, bins.long(), match_valid.to(torch.int32))
    # stable descending sort: ties go to the lower bin, as lax.top_k does
    top_v, top_i = torch.sort(hist, descending=True, stable=True)
    th = 0.1 * top_v[0].to(torch.float32)
    keep2 = torch.where(top_v[1] > th, top_i[1], -1)
    keep3 = torch.where(top_v[2] > th, top_i[2], -1)
    ok = (bins == top_i[0]) | (bins == keep2) | (bins == keep3)
    return match_valid & ok


def search_by_bow(desc_a, valid_a, angle_a, desc_b, valid_b, angle_b, ratio: float,
                  caller: str = "search_by_bow"):
    """SearchByBoW core (reference ORBmatcher.cpp:110-239) without the
    vocabulary: mutual-ratio Hamming matching + rotation consistency, K3's
    launch counted under `caller` (the tracker's reference-keyframe path,
    or `relocalization`). Returns (idx [A] into B, best [A], keep [A])."""
    mask = valid_a[:, None] & valid_b[None, :]
    idx, best, _, second = hamming.best2(desc_a, desc_b, mask, caller)
    ok = (best < hamming.TH_LOW) & (best < ratio * second)
    keep = rotation_consistency_mask(angle_a, angle_b[idx.long()], ok)
    return idx, best, keep


def search_by_bow_nodes(desc_a, valid_a, angle_a, node_a, desc_b, valid_b, angle_b, node_b, ratio: float,
                        caller: str = "loop"):
    """SearchByBoW with the reference's FeatureVector-node bucketing
    (ORBmatcher.cpp:354-487): candidate pairs are features whose
    descriptors descend to the same vocabulary node (node_a, node_b [A],
    [B] int32, -1 for none), and the ratio test runs within that bucket.
    K3's `nodes` mode evaluates the node gate in the kernel, so no [A, B]
    mask is built; then the ratio test, TH_LOW and rotation consistency as
    in `search_by_bow`; K3's launch counted under `caller` (the loop
    closer). Returns (idx [A] into B, best [A], keep [A])."""
    gate = hamming.Gate("nodes", row_valid=valid_a, col_valid=valid_b, row_node=node_a, col_node=node_b)
    idx, best, _, second = hamming.best2_gated(desc_a, desc_b, gate, caller)
    ok = (best < hamming.TH_LOW) & (best < ratio * second)
    keep = rotation_consistency_mask(angle_a, angle_b[idx.long()], ok)
    return idx, best, keep


def bow_node_matches(desc_a, valid_a, angle_a, node_a, desc_b, valid_b, angle_b, node_b, ratio: float):
    """`search_by_bow_nodes` with B-side collisions resolved (best distance,
    then the lowest row, wins): (idx [A] into B, win [A] bool), the JAX
    loop closer's per-candidate matching (`_bow_batch`)."""
    idx, best, keep = search_by_bow_nodes(desc_a, valid_a, angle_a, node_a, desc_b, valid_b, angle_b,
                                          node_b, ratio)
    src, _ = _resolve_collisions(idx, torch.where(keep, best, hamming.MAX_DIST), desc_b.shape[0])
    rows = torch.arange(desc_a.shape[0], dtype=torch.int32, device=idx.device)
    return idx, keep & (src[idx.long()] == rows)


class StereoMatches(NamedTuple):
    u_right: torch.Tensor  # [N] float32, -1 where unmatched
    depth: torch.Tensor  # [N] float32, -1 where unmatched
    valid: torch.Tensor  # [N] bool


def stereo_match(uvL, octL, descL, validL, uvR, octR, descR, validR,
                 scale_factors: torch.Tensor, bf: float, min_z: float) -> StereoMatches:
    """Left-right ORB matching for a rectified pair (reference
    Frame::ComputeStereoMatches, src/Frame.cpp:538-673): row band
    +-2*sigma(octave of L), octave gate +-1, disparity in (0, bf/min_z],
    Hamming < (TH_HIGH+TH_LOW)/2, then the 1.5*1.4*median distance cut."""
    th_orb = (hamming.TH_HIGH + hamming.TH_LOW) // 2
    max_d = bf / min_z

    gate = hamming.Gate(
        "stereo", uvL, 2.0 * scale_factors[octL.long()], octL, validL, uvR, octR, validR,
        row_umin=uvL[:, 0] - max_d,
    )
    best_idx, best_dist, _, _ = hamming.best2_gated(descL, descR, gate)

    u_right = uvR[best_idx.long(), 0]
    disparity = uvL[:, 0] - u_right
    matched = (best_dist < th_orb) & (disparity >= 0.0) & (disparity < max_d)
    # clamp near-zero disparity exactly like the reference (Frame.cpp:652-656)
    disparity = torch.where(disparity <= 0.0, 0.01, disparity)
    u_right = torch.where(disparity <= 0.01, uvL[:, 0] - 0.01, u_right)

    # median-distance cut over accepted matches
    d_acc = torch.where(matched, best_dist, hamming.MAX_DIST)
    n_acc = matched.sum()
    sorted_d = torch.sort(d_acc).values
    median = sorted_d[torch.clamp(n_acc // 2, 0, d_acc.shape[0] - 1)]
    th_dist = (1.5 * 1.4) * median.to(torch.float32)
    keep = matched & (best_dist < th_dist)

    bf_t = torch.tensor(bf, dtype=torch.float32, device=disparity.device)
    depth = torch.where(keep, bf_t / disparity, -1.0)
    return StereoMatches(u_right=torch.where(keep, u_right, -1.0), depth=depth, valid=keep)


def search_by_projection_frame(
    uv_cur, oct_cur, desc_cur, valid_cur, angle_cur,
    uv_proj, oct_last, desc_last, valid_proj, angle_last,
    scale_factors: torch.Tensor, th: float, forward: bool, backward: bool,
    check_rotation: bool = True,
):
    """Frame-to-frame projection matching (reference SearchByProjection(
    Frame&, Frame&, th), ORBmatcher.cpp:1173-1315): for each projected
    last-frame point, the best current keypoint in a th*sigma window with
    forward/backward octave gating. Returns (point index per current
    keypoint [-1 none], distance)."""
    radius = th * scale_factors[oct_last.long()]  # [M]
    oct_mode = "forward" if forward else "backward" if backward else "both"
    gate = hamming.Gate("frame", uv_proj, radius, oct_last, valid_proj, uv_cur, oct_cur, valid_cur,
                        oct_mode=oct_mode)
    best_idx, best_dist, _, _ = hamming.best2_gated(desc_last, desc_cur, gate)
    ok = best_dist <= hamming.TH_HIGH
    if check_rotation:
        ok = rotation_consistency_mask(angle_last, angle_cur[best_idx.long()], ok)
    d_eff = torch.where(ok, best_dist, hamming.MAX_DIST)
    return _resolve_collisions(best_idx, d_eff, uv_cur.shape[0])


def search_by_projection_points(
    uv_cur, oct_cur, ur_cur, desc_cur, valid_cur,
    uv_pt, ur_pt, level_pt, view_cos, desc_pt, valid_pt,
    scale_factors: torch.Tensor, th: float, nn_ratio: float = 0.8,
):
    """Local-map projection matching (reference SearchByProjection(Frame&,
    vector<MapPoint*>&, th), ORBmatcher.cpp:16-100): radius 2.5/4.0 by
    viewing angle scaled by sigma(predicted level), octave in [pred-1,
    pred], the 0.8 ratio test when best and second best share a level,
    TH_HIGH, and stereo right-coordinate agreement. Returns (point index
    per keypoint [-1 none], distance)."""
    r_base = torch.where(view_cos > 0.998, 2.5, 4.0)
    radius = th * r_base * scale_factors[level_pt.long()]
    gate = hamming.Gate("points", uv_pt, radius, level_pt, valid_pt, uv_cur, oct_cur, valid_cur,
                        row_ur=ur_pt, col_ur=ur_cur)
    best_idx, best, second_idx, second = hamming.best2_gated(desc_pt, desc_cur, gate)

    best_oct = oct_cur[best_idx.long()]
    second_oct = oct_cur[second_idx.long()]
    ratio_applies = (best_oct == second_oct) & (second < hamming.MAX_DIST)
    ratio_ok = torch.where(ratio_applies, best.to(torch.float32) <= nn_ratio * second, True)
    ok = (best <= hamming.TH_HIGH) & ratio_ok & valid_pt
    d_eff = torch.where(ok, best, hamming.MAX_DIST)
    return _resolve_collisions(best_idx, d_eff, uv_cur.shape[0])


def epipolar_match(uv1, desc1, free1, angle1, stereo1, uv2, oct2, desc2, free2, angle2, stereo2,
                   F12: torch.Tensor, epipole2: torch.Tensor, scale_factors: torch.Tensor,
                   level_sigma2: torch.Tensor):
    """Best epipolar-consistent match in kf2 for each free kf1 feature
    (reference SearchForTriangulation, ORBmatcher.cpp:489-669): Hamming <
    TH_LOW, epipolar distance^2 < 3.84 sigma2(oct2), mono-mono pairs more
    than 10 sqrt(sf(oct2)) px from the epipole, rotation consistency, and
    kf2-side uniqueness where every kf1 row tied at a column's best
    distance wins. Returns (match index per kf1 feature [-1 none], best
    distance)."""
    ones = torch.ones((uv1.shape[0], 1), dtype=uv1.dtype, device=uv1.device)
    line = torch.cat([uv1, ones], dim=-1) @ F12  # [N, 3]: (a, b, c) of the line in image 2
    a, b, c = line[:, 0:1], line[:, 1:2], line[:, 2:3]
    num = a * uv2[None, :, 0] + b * uv2[None, :, 1] + c
    den = a * a + b * b
    dsq = num * num / torch.where(den < 1e-12, 1e-12, den)
    oct2l = oct2.long()
    epi_ok = dsq < 3.84 * level_sigma2[oct2l][None, :]
    de = uv2 - epipole2[None, :]
    epipole_dist2 = torch.sum(de * de, dim=-1)
    both_mono = ~stereo1[:, None] & ~stereo2[None, :]
    epipole_ok = ~both_mono | (epipole_dist2 >= 100.0 * scale_factors[oct2l])[None, :]
    mask = epi_ok & epipole_ok & free1[:, None] & free2[None, :]
    best_idx, best, _, _ = hamming.best2(desc1, desc2, mask, caller="epipolar_match")
    ok = best < hamming.TH_LOW
    idx = best_idx.long()
    ok = rotation_consistency_mask(angle1, angle2[idx], ok)
    d_eff = torch.where(ok, best, hamming.MAX_DIST)
    per2_best = torch.full((uv2.shape[0],), hamming.MAX_DIST, dtype=d_eff.dtype, device=d_eff.device)
    per2_best = per2_best.scatter_reduce(0, idx, d_eff, reduce="amin")
    win = ok & (d_eff == per2_best[idx])
    return torch.where(win, best_idx, -1), best


def fuse_match(uv_kp, oct_kp, ur_kp, desc_kp, valid_kp, uv_pt, ur_pt, level_pt, desc_pt, valid_pt,
               scale_factors: torch.Tensor, inv_level_sigma2: torch.Tensor, th: float = 3.0,
               caller: Optional[str] = None):
    """Map-point fusion into a keyframe (reference ORBmatcher::Fuse,
    ORBmatcher.cpp:671-821): for each projected point the best keypoint
    within radius th sigma(predicted level), octave in [pred-1, pred],
    reprojection chi2 <= 5.99 (mono keypoint) / 7.8 (stereo keypoint),
    Hamming <= TH_LOW, through K3's `fuse` mode (its launch counted under
    `caller` when given: the loop closer's `sim3` and `loop_fusion`).
    Returns (keypoint index per point [-1 none], best distance)."""
    gate = hamming.Gate("fuse", uv_pt, th * scale_factors[level_pt.long()], level_pt, valid_pt,
                        uv_kp, oct_kp, valid_kp, row_ur=ur_pt, col_ur=ur_kp,
                        col_isig=inv_level_sigma2[oct_kp.long()])
    best_idx, best, _, _ = hamming.best2_gated(desc_pt, desc_kp, gate, caller)
    return torch.where(best <= hamming.TH_LOW, best_idx, -1), best
