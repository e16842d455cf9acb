"""Batched ORB feature extraction (pyramid + FAST + IC angle + rBRIEF).

Port of orbslam2_tpu/ops/orb.py (reference src/ORBextractor.cpp): an
8-level pyramid, FAST with the per-cell 20/7 threshold fallback, a
grid-balanced top-k keypoint selection, intensity-centroid orientation,
7x7 Gaussian blur and 256-bit rotated BRIEF quantized to 32 bins, over a
batch of images (left and right eye together).

`extract` runs in three stages over the whole pyramid: the cascaded
bilinear resize (`F.interpolate`), then ONE call of the FAST score with
NMS for every level (kernel K2, `fast.fast_nms_levels`), the keypoint
selection per level in plain PyTorch, then ONE call of the fused patch +
descriptor kernel for every keypoint (K1, `patches.orb_patch_desc_levels`).
No level's features feed another's, so this computes what the JAX
package's level-by-level loop computes. The deviations from the reference
are the JAX package's, documented in its module docstring.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from . import fast, patches

KP_BORDER = 16  # keypoint-to-edge min distance (EDGE_THRESHOLD - 3)
CELL = 30  # FAST threshold-fallback cell size (reference 30x30 px cells)


class OrbParams(NamedTuple):
    n_features: int = 1200
    n_levels: int = 8
    scale_factor: float = 1.2
    ini_th: float = 20.0
    min_th: float = 7.0


class OrbFeatures(NamedTuple):
    """Struct-of-arrays keypoints, fixed capacity N = n_features.

    uv [B,N,2] float32 level-0 pixels; octave [B,N] int32; angle [B,N]
    radians; response [B,N] FAST score; desc [B,N,8] int32; valid [B,N].
    """

    uv: torch.Tensor
    octave: torch.Tensor
    angle: torch.Tensor
    response: torch.Tensor
    desc: torch.Tensor
    valid: torch.Tensor


def scale_factors(params: OrbParams) -> np.ndarray:
    return params.scale_factor ** np.arange(params.n_levels)


def level_sigma2(params: OrbParams) -> np.ndarray:
    """Per-octave measurement variance (reference mvLevelSigma2)."""
    return scale_factors(params) ** 2


def features_per_level(params: OrbParams) -> list[int]:
    """Geometric feature budget (reference src/ORBextractor.cpp:372-383)."""
    f = 1.0 / params.scale_factor
    n_desired = params.n_features * (1 - f) / (1 - f**params.n_levels)
    out = []
    total = 0
    for _ in range(params.n_levels - 1):
        n = int(round(n_desired))
        out.append(n)
        total += n
        n_desired *= f
    out.append(max(params.n_features - total, 0))
    return out


def level_sizes(H: int, W: int, params: OrbParams) -> list[tuple[int, int]]:
    return [(int(round(H / s)), int(round(W / s))) for s in scale_factors(params)]


def _cell_any(mask: torch.Tensor, cell: int) -> torch.Tensor:
    """Per-(cell x cell) block 'any' of a [B,H,W] mask, broadcast back."""
    B, H, W = mask.shape
    gh, gw = -(-H // cell), -(-W // cell)
    m = F.pad(mask, (0, gw * cell - W, 0, gh * cell - H))
    pooled = m.reshape(B, gh, cell, gw, cell).any(dim=4).any(dim=2)
    up = pooled.repeat_interleave(cell, dim=1).repeat_interleave(cell, dim=2)
    return up[:, :H, :W]


def _select_level_keypoints(s: torch.Tensor, n_target: int, ini_th: float, min_th: float):
    """Masked FAST score s [B,h,w] (after NMS) -> (xs, ys, resp, valid),
    each [B, n_target].

    The reference's two-threshold cell fallback (src/ORBextractor.cpp:
    726-760), a 16 px border, the best two keypoints per grid cell by max
    over packed (quantized score << pos_bits | position) int32 keys, then a
    global top-k. The keys are unique, so `torch.topk` picks what
    `lax.top_k` picks."""
    B, h, w = s.shape
    dev = s.device
    hi = s > ini_th
    keep = hi | ((s > min_th) & ~_cell_any(hi, CELL))

    ys_g = torch.arange(h, device=dev)[:, None]
    xs_g = torch.arange(w, device=dev)[None, :]
    border = (
        (xs_g >= KP_BORDER) & (xs_g <= w - 1 - KP_BORDER)
        & (ys_g >= KP_BORDER) & (ys_g <= h - 1 - KP_BORDER)
    )
    s = torch.where(keep & border[None], s, 0.0)

    # grid: ~square cells, at least n_target of them
    usable = max((h - 2 * KP_BORDER) * (w - 2 * KP_BORDER), 1)
    c = max(int(math.sqrt(usable / max(n_target, 1))), 4)
    while ((h + c - 1) // c) * ((w + c - 1) // c) < n_target and c > 4:
        c -= 1
    gy, gx = (h + c - 1) // c, (w + c - 1) // c

    pos_bits = max((h * w - 1).bit_length(), 1)
    score_q = torch.clamp((s * 4.0).to(torch.int32), 0, (1 << (31 - pos_bits)) - 1)
    flat_pos = (ys_g * w + xs_g).to(torch.int32)
    packed = torch.where(s > 0.0, (score_q << pos_bits) | flat_pos[None], -1)
    pp = F.pad(packed, (0, gx * c - w, 0, gy * c - h), value=-1)
    best1 = pp.reshape(B, gy, c, gx, c).amax(dim=(2, 4))
    up1 = best1.repeat_interleave(c, dim=1).repeat_interleave(c, dim=2)
    best2 = torch.where(pp == up1, -1, pp).reshape(B, gy, c, gx, c).amax(dim=(2, 4))
    cand = torch.cat([best1.reshape(B, -1), best2.reshape(B, -1)], dim=-1)

    k = min(n_target, 2 * gy * gx)
    top_p = torch.topk(cand, k, dim=-1, sorted=True).values
    valid = top_p >= 0
    pos = torch.where(valid, top_p & ((1 << pos_bits) - 1), 0)
    ys = torch.div(pos, w, rounding_mode="floor")
    xs = pos % w
    top_v = torch.where(valid, (top_p >> pos_bits).to(torch.float32) * 0.25, 0.0)
    if k < n_target:  # tiny images: pad out
        padn = n_target - k
        xs, ys, top_v, valid = (F.pad(a, (0, padn)) for a in (xs, ys, top_v, valid))
    return xs.to(torch.int32), ys.to(torch.int32), top_v, valid


def pyramid_level(img: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """Cascaded linear resize without antialiasing (reference
    ComputePyramid; `jax.image.resize(linear, antialias=False)`)."""
    return F.interpolate(
        img[:, None], size=size, mode="bilinear", align_corners=False, antialias=False
    )[:, 0]


def extract(images: torch.Tensor, params: OrbParams) -> OrbFeatures:
    """images [B,H,W] float32 (0..255 grayscale) -> OrbFeatures with
    N = params.n_features slots per image."""
    B, H, W = images.shape
    budgets = features_per_level(params)
    sf = scale_factors(params)

    pyramid = [images]
    for size in level_sizes(H, W, params)[1:]:
        pyramid.append(pyramid_level(pyramid[-1], size))
    kept = [lvl for lvl, n_t in enumerate(budgets) if n_t > 0]
    levels = [pyramid[lvl] for lvl in kept]
    scores = fast.fast_nms_levels(levels)

    xs_l, ys_l, uv_l, oct_l, resp_l, valid_l = [], [], [], [], [], []
    for lvl, s in zip(kept, scores):
        xs, ys, resp, valid = _select_level_keypoints(s, budgets[lvl], params.ini_th, params.min_th)
        # clamp invalid slots to a safe in-bounds position
        xs = torch.where(valid, xs, KP_BORDER)
        ys = torch.where(valid, ys, KP_BORDER)
        scale = torch.tensor(sf[lvl], dtype=torch.float32)
        xs_l.append(xs)
        ys_l.append(ys)
        uv_l.append(torch.stack([xs * scale, ys * scale], dim=-1))
        oct_l.append(torch.full((B, budgets[lvl]), lvl, dtype=torch.int32, device=images.device))
        resp_l.append(resp)
        valid_l.append(valid)

    angle, desc = patches.orb_patch_desc_levels(levels, xs_l, ys_l)
    return OrbFeatures(
        uv=torch.cat(uv_l, dim=1),
        octave=torch.cat(oct_l, dim=1),
        angle=angle,
        response=torch.cat(resp_l, dim=1),
        desc=desc,
        valid=torch.cat(valid_l, dim=1),
    )
