"""FAST-9/16 corner scoring with 3x3 NMS, and kernel K2.

Port of orbslam2_tpu/ops/fast.py (reference per-cell cv::FAST,
src/ORBextractor.cpp:702-766): the OpenCV-style FAST score map (the
largest threshold at which a pixel is still a corner) for every pixel of
every image of the batch, then 3x3 non-maximum suppression.

`fast_nms_levels` returns, for every pyramid level of a frame, the masked
score `where(nms3(score), score, 0)` that the extractor selects keypoints
from (orbslam2_tpu/ops/orb.py:216-217); `fast_nms` is its one-level case.
On CUDA tensors it makes one launch of the hand-written kernel
`csrc/fast_nms.cu` for all levels. Every step is a min, a max or one float
subtraction, so the kernel and the plain version agree bit for bit.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ..convert import CIRCLE
from ..kernels import build

def _edge_pad3(img: torch.Tensor) -> torch.Tensor:
    """Replicate-pad the last two axes by 3 (`jnp.pad(mode="edge")`)."""
    H, W = img.shape[-2], img.shape[-1]
    p = F.pad(img.reshape(-1, 1, H, W), (3, 3, 3, 3), mode="replicate")
    return p.reshape(*img.shape[:-2], H + 6, W + 6)


#: pixels per band of rows in `fast_score`: a band's 24 ring planes stay in
#: a core's cache
_BAND_PX = 16384


def _arc_score(d24: torch.Tensor) -> torch.Tensor:
    """FAST-9 score from the ring differences d24 [24, ...]: the 16 in ring
    order, then the first 8 again (arcs wrap around the ring). The darkest
    and brightest of each arc of 9 by log-doubling over the ring planes
    (9 = 8 + 1), then the largest threshold at which an arc is all brighter
    or all darker."""
    score = None
    for op in (torch.minimum, torch.maximum):
        w = op(d24[:-1], d24[1:])  # arcs of 2 starting at 0..22
        w = op(w[:-2], w[2:])  # 4, at 0..20
        w = op(w[:-4], w[4:])  # 8, at 0..16
        w = op(w[:16], d24[8:24])  # 9, at 0..15
        s = w.amax(0) if op is torch.minimum else -w.amin(0)
        score = s if score is None else torch.maximum(score, s)
    return torch.clamp(score, min=0.0)


def fast_score(img: torch.Tensor) -> torch.Tensor:
    """FAST-9/16 score map of [..., H, W] float32 grayscale (0..255), in
    bands of rows (every step is a min, a max or one subtraction: the band
    changes no bit)."""
    H, W = img.shape[-2], img.shape[-1]
    ip = _edge_pad3(img)
    out = torch.empty_like(img)
    band = max(1, _BAND_PX // max(1, W * (img.numel() // max(1, H * W))))
    for y0 in range(0, H, band):
        y1 = min(y0 + band, H)
        ring = [ip[..., 3 + dy + y0: 3 + dy + y1, 3 + dx: 3 + dx + W] for (dx, dy) in CIRCLE]
        d24 = torch.stack(ring + ring[:8])
        out[..., y0:y1, :] = _arc_score(d24.sub_(img[..., y0:y1, :]))
    return out


def nms3(score: torch.Tensor) -> torch.Tensor:
    """3x3 NMS mask: True where score is the (tied) local max and > 0;
    outside the image counts as -inf. The 3x3 max is taken as a max over 3
    rows, then over 3 columns (a max is exact: `max_pool2d`'s value)."""
    p = F.pad(score, (1, 1, 1, 1), value=-float("inf"))
    rows = torch.maximum(torch.maximum(p[..., :-2, :], p[..., 1:-1, :]), p[..., 2:, :])
    neigh = torch.maximum(torch.maximum(rows[..., :-2], rows[..., 1:-1]), rows[..., 2:])
    return (score >= neigh) & (score > 0.0)


def fast_nms_plain(img: torch.Tensor) -> torch.Tensor:
    """Plain version of K2: the NMS-masked FAST score of [B, H, W]."""
    score = fast_score(img)
    return torch.where(nms3(score), score, 0.0)


def fast_nms_levels_plain(levels: list[torch.Tensor]) -> list[torch.Tensor]:
    """Plain version of the all-level K2 launch: `fast_nms_plain` per level."""
    return [fast_nms_plain(img) for img in levels]


# csrc/fast_nms.cu: at most MAX_LEVELS level descriptors
MAX_LEVELS = 16


class _Level(ctypes.Structure):
    _fields_ = [("img", ctypes.c_void_p), ("out", ctypes.c_void_p), ("h", ctypes.c_int), ("w", ctypes.c_int)]


class _Levels(ctypes.Structure):
    """`FastLevelsIn` of csrc/fast_nms.cu. The launcher lays the levels'
    tiles out in one grid and sets `n_blocks` to the blocks it launched."""

    _fields_ = [
        ("lv", _Level * MAX_LEVELS), ("n_levels", ctypes.c_int), ("n_images", ctypes.c_int),
        ("n_blocks", ctypes.c_int),
    ]


def fast_nms_levels(levels: list[torch.Tensor]) -> list[torch.Tensor]:
    """K2 wrapper over every level of a frame: the masked FAST score of each
    float32 [B, h, w] level (B images, the same at every level). CPU
    tensors take the plain version; CUDA tensors take ONE launch of
    `fast_nms_levels_launch` over every level and image."""
    if not 0 < len(levels) <= MAX_LEVELS:
        raise ValueError(f"fast_nms_levels takes 1..{MAX_LEVELS} levels, got {len(levels)}")
    dev = levels[0].device
    if dev.type == "cpu":
        return fast_nms_levels_plain(levels)
    if dev.type != "cuda":
        raise ValueError(f"fast_nms_levels: unsupported device {dev}")
    B = levels[0].shape[0]
    outs = []
    args = _Levels(n_levels=len(levels), n_images=B)
    for d, img in zip(args.lv, levels):
        shape = img.shape
        if (img.device != dev or img.dtype != torch.float32 or len(shape) != 3 or shape[0] != B
                or not img.is_contiguous()):
            raise ValueError(f"fast_nms_levels takes contiguous float32 [B,h,w] levels on one device, "
                             f"got {img.dtype} {tuple(shape)} on {img.device}")
        out = torch.empty_like(img)
        outs.append(out)
        d.img, d.out, d.h, d.w = img.data_ptr(), out.data_ptr(), shape[1], shape[2]
    build.launch("fast_nms_levels_launch", args)
    if args.n_blocks:
        fast_nms_levels.launches += 1
    return outs


fast_nms_levels.launches = 0


def fast_nms(img: torch.Tensor) -> torch.Tensor:
    """K2 on one level: the masked FAST score of float32 [B, H, W]."""
    return fast_nms_levels([img])[0]
