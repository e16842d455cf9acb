"""Batched ORB feature extraction (pyramid + FAST + IC angle + rBRIEF).

Port of orbslam2_tpu/ops/orb.py (reference src/ORBextractor.cpp): an
8-level pyramid, FAST with the per-cell 20/7 threshold fallback, a
grid-balanced top-k keypoint selection, intensity-centroid orientation,
7x7 Gaussian blur and 256-bit rotated BRIEF quantized to 32 bins, over a
batch of images (left and right eye together).

`extract` runs in four stages over the whole pyramid: the cascaded
bilinear resize (`F.interpolate`), then ONE call of the FAST score with
NMS for every level (kernel K2, `fast.fast_nms_levels`), ONE call of the
keypoint selection for every level (K6, `select_keypoints_levels`), then
ONE call of the fused patch + descriptor kernel for every keypoint (K1,
`patches.orb_patch_desc_levels`). No level's features feed another's, so
this computes what the JAX package's level-by-level loop computes. The
deviations from the reference are the JAX package's, documented in its
module docstring.
"""

from __future__ import annotations

import ctypes
import math
import threading
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import convert
from ..kernels import build
from . import fast, patches

EDGE = 19  # sampling border (reference EDGE_THRESHOLD)
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


def ic_angle(img_pad: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor) -> torch.Tensor:
    """Intensity-centroid angle (reference IC_Angle, src/ORBextractor.cpp:
    77-104) of the radius-15 disc around each keypoint: img_pad [Hp, Wp]
    padded by EDGE, xs/ys [K] integer level coordinates -> [K] radians.
    The disc and moment tables are those of K1's plain version
    (`convert.IC_MASK`, `IC_DX`, `IC_DY`); K1 computes the same angle inside
    its kernel. Port of orbslam2_tpu/ops/orb.py::_ic_angle_single."""
    d = torch.arange(-15, 16, device=img_pad.device)
    rows = ys.long()[:, None, None] + d[None, :, None] + EDGE
    cols = xs.long()[:, None, None] + d[None, None, :] + EDGE
    patch = img_pad[rows, cols]
    mask = torch.from_numpy(convert.IC_MASK).to(img_pad.device)
    m10 = torch.sum(patch * (torch.from_numpy(convert.IC_DX).to(img_pad.device) * mask), dim=(-2, -1))
    m01 = torch.sum(patch * (torch.from_numpy(convert.IC_DY).to(img_pad.device) * mask), dim=(-2, -1))
    return torch.atan2(m01, m10)


def gauss7(img: torch.Tensor) -> torch.Tensor:
    """7x7 sigma=2 Gaussian blur (reference cv::GaussianBlur before the
    descriptors) of [..., H, W]: reflect padding by 3, then the separable
    taps of K1's plain version (`convert.G7`) added by shift and add, rows
    first, in the order of orbslam2_tpu/ops/orb.py::gauss7."""
    H, W = img.shape[-2:]
    g7 = [float(g) for g in convert.G7]

    def pad(x):
        return F.pad(x.reshape(-1, 1, H, W), (3, 3, 3, 3), mode="reflect").reshape(*img.shape[:-2], H + 6, W + 6)

    ip = pad(img)
    row = torch.zeros_like(img)
    for k in range(7):
        row = row + g7[k] * ip[..., 3:3 + H, k:k + W]
    rp = pad(row)
    out = torch.zeros_like(img)
    for k in range(7):
        out = out + g7[k] * rp[..., k:k + H, 3:3 + W]
    return out


def _cell_any(mask: torch.Tensor, cell: int) -> torch.Tensor:
    """Per-(cell x cell) block 'any' of a [B,H,W] mask, broadcast back."""
    B, H, W = mask.shape
    gh, gw = -(-H // cell), -(-W // cell)
    m = F.pad(mask, (0, gw * cell - W, 0, gh * cell - H))
    pooled = m.reshape(B, gh, cell, gw, cell).any(dim=4).any(dim=2)
    up = pooled.repeat_interleave(cell, dim=1).repeat_interleave(cell, dim=2)
    return up[:, :H, :W]


def _level_grid(h: int, w: int, n_target: int):
    """(c, gy, gx, pos_bits): the selection's grid of ~square c x c cells,
    at least n_target of them (gy x gx), and the bits of a packed key's
    position part."""
    usable = max((h - 2 * KP_BORDER) * (w - 2 * KP_BORDER), 1)
    c = max(int(math.sqrt(usable / max(n_target, 1))), 4)
    while ((h + c - 1) // c) * ((w + c - 1) // c) < n_target and c > 4:
        c -= 1
    return c, (h + c - 1) // c, (w + c - 1) // c, max((h * w - 1).bit_length(), 1)


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

    c, gy, gx, pos_bits = _level_grid(h, w, n_target)
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


def select_keypoints_levels_plain(scores, budgets, ini_th: float, min_th: float):
    """Plain version of K6: `_select_level_keypoints` per level, with the
    extractor's clamp of an empty slot's x and y to KP_BORDER. Returns the
    lists (xs, ys, resp, valid), level l's entries [B, budgets[l]]."""
    out = ([], [], [], [])
    for s, n_t in zip(scores, budgets):
        xs, ys, resp, valid = _select_level_keypoints(s, n_t, ini_th, min_th)
        for lst, a in zip(out, (torch.where(valid, xs, KP_BORDER), torch.where(valid, ys, KP_BORDER), resp, valid)):
            lst.append(a)
    return out


# csrc/select_keypoints.cu: at most MAX_LEVELS level descriptors
MAX_LEVELS = 16


class _SelLevel(ctypes.Structure):
    _fields_ = [
        ("score", ctypes.c_void_p), ("h", ctypes.c_int), ("w", ctypes.c_int), ("n_target", ctypes.c_int),
        ("c", ctypes.c_int), ("gy", ctypes.c_int), ("gx", ctypes.c_int), ("pos_bits", ctypes.c_int),
    ]


class _SelArgs(ctypes.Structure):
    """`SelArgsIn` of csrc/select_keypoints.cu. The launcher lays the
    levels out and sets `n_blocks` to the blocks of its cell pass."""

    _fields_ = [
        ("lv", _SelLevel * MAX_LEVELS),
        ("xs", ctypes.c_void_p), ("ys", ctypes.c_void_p), ("resp", ctypes.c_void_p), ("valid", ctypes.c_void_p),
        ("part", ctypes.c_void_p), ("part_len", ctypes.c_longlong), ("ini_th", ctypes.c_float),
        ("min_th", ctypes.c_float), ("n_levels", ctypes.c_int), ("n_images", ctypes.c_int),
        ("n_blocks", ctypes.c_int),
    ]


def _partial_slots(c: int, gy: int, gx: int) -> int:
    """Scratch ints of one image of a level in csrc/select_keypoints.cu: a
    pair per grid cell and per cell-pass block it can overlap (30-row bands
    by 240-column chunks)."""
    return gy * gx * ((c + CELL - 2) // CELL + 1) * ((c + 8 * CELL - 2) // (8 * CELL) + 1) * 2


_count_lock = threading.Lock()


def select_keypoints_levels(scores, budgets, ini_th: float, min_th: float):
    """K6 wrapper over every level of a frame: masked FAST scores float32
    [B, h_l, w_l] (K2's output) and per level its budget n_l -> lists
    (xs, ys int32, resp float32, valid bool), level l's entries [B, n_l];
    an empty slot holds x = y = KP_BORDER. CPU tensors take the plain
    version; CUDA tensors take one call of `select_keypoints_launch`, its
    two kernels (cell pass, top-k pass) over every level and image, each
    counted, into one buffer per output."""
    if not 0 < len(scores) <= MAX_LEVELS or len(budgets) != len(scores):
        raise ValueError(f"select_keypoints_levels takes 1..{MAX_LEVELS} levels with a budget each")
    dev = scores[0].device
    if dev.type == "cpu":
        return select_keypoints_levels_plain(scores, budgets, ini_th, min_th)
    if dev.type != "cuda":
        raise ValueError(f"select_keypoints_levels: unsupported device {dev}")
    B = scores[0].shape[0]
    args = _SelArgs(ini_th=ini_th, min_th=min_th, n_levels=len(scores), n_images=B)
    n_out = n_part = 0
    for d, s, n_t in zip(args.lv, scores, budgets):
        shape = s.shape
        if (s.device != dev or s.dtype != torch.float32 or len(shape) != 3 or shape[0] != B
                or not s.is_contiguous() or n_t < 0):
            raise ValueError(f"select_keypoints_levels takes contiguous float32 [B,h,w] scores on one device "
                             f"and budgets >= 0, got {s.dtype} {tuple(shape)} on {s.device}, budget {n_t}")
        c, gy, gx, pos_bits = _level_grid(shape[1], shape[2], n_t)
        d.score, d.h, d.w, d.n_target = s.data_ptr(), shape[1], shape[2], n_t
        d.c, d.gy, d.gx, d.pos_bits = c, gy, gx, pos_bits
        n_out += n_t
        n_part += _partial_slots(c, gy, gx)
    xs, ys = (torch.empty(B * n_out, dtype=torch.int32, device=dev) for _ in range(2))
    resp = torch.empty(B * n_out, dtype=torch.float32, device=dev)
    valid = torch.empty(B * n_out, dtype=torch.bool, device=dev)
    part = torch.empty(B * n_part, dtype=torch.int32, device=dev)
    args.xs, args.ys, args.resp, args.valid, args.part = (
        t.data_ptr() for t in (xs, ys, resp, valid, part))
    args.part_len = B * n_part
    build.launch("select_keypoints_launch", args)
    if args.n_blocks:
        with _count_lock:
            select_keypoints_levels.launches += 2
    out = ([], [], [], [])
    first = 0
    for n_t in budgets:
        for lst, t in zip(out, (xs, ys, resp, valid)):
            lst.append(t[B * first:B * (first + n_t)].view(B, n_t))
        first += n_t
    return out


#: kernels launched: two per call with work (the cell pass and the top-k pass)
select_keypoints_levels.launches = 0

#: per (device, kept levels, budgets): each slot's level scale and octave,
#: made once (on the card an upload per frame would wait for the copy)
_COLUMNS = {}


def _level_columns(dev, kept, budgets, sf):
    """(scale float32 [N], octave int32 [N]) of the N slots of `kept`
    levels with `budgets`, on `dev`."""
    key = (str(dev), tuple(kept), tuple(budgets))
    cols = _COLUMNS.get(key)
    if cols is None:
        n = [budgets[lvl] for lvl in kept]
        cols = (torch.from_numpy(np.repeat(sf[kept].astype(np.float32), n)).to(dev),
                torch.from_numpy(np.repeat(np.asarray(kept, np.int32), n)).to(dev))
        _COLUMNS[key] = cols
    return cols


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
    xs_l, ys_l, resp_l, valid_l = select_keypoints_levels(
        scores, [budgets[lvl] for lvl in kept], params.ini_th, params.min_th)
    angle, desc = patches.orb_patch_desc_levels(levels, xs_l, ys_l)
    scale, octave = _level_columns(images.device, kept, budgets, sf)
    xs, ys = torch.cat(xs_l, dim=1), torch.cat(ys_l, dim=1)
    return OrbFeatures(
        uv=torch.stack([xs * scale, ys * scale], dim=-1),
        octave=octave.repeat(B, 1),
        angle=angle,
        response=torch.cat(resp_l, dim=1),
        desc=desc,
        valid=torch.cat(valid_l, dim=1),
    )
