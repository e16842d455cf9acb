"""Per-keypoint patch fetch and ORB descriptor math, and kernel K1.

Port of the JAX package's one Pallas kernel, orbslam2_tpu/ops/patches.py::
extract_patches (pallas_call at :103), fused with orbslam2_tpu/ops/orb.py::
_features_from_patches (:350-393). On the TPU the fetch needed (8, 128)
tile-aligned DMA windows and a one-hot row shift; here none of that
envelope is kept: each keypoint's 48x48 window of the level, extended by
24 px of reflection, is read where it lies.

`orb_patch_desc_levels` is the extractor's entry point, `orb_patch_desc`
its one-level case. On CUDA tensors it makes one launch of
`csrc/orb_patch_desc.cu` for every keypoint of every level (one block per
keypoint; patch, moments, blur and rBRIEF all in shared memory; reflect
indices computed in the kernel, no padded copy of the level); on CPU
tensors it runs the plain version below, which mirrors the JAX package's
math (moments and blur as float32 matrix products).
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from .. import convert
from ..kernels import build

PATCH = convert.PATCH
PATCH_C = convert.PATCH_C
PAD = 24  # reflect padding of the level image (orb.py:439-442)
_BINS_PER_RADIAN = convert.N_ANGLE_BINS / (2.0 * math.pi)
_BIT_SHIFTS = torch.arange(32, dtype=torch.int64)


def pad_level(img: torch.Tensor) -> torch.Tensor:
    """[B, h, w] -> [B, h + 48, w + 48], reflect-padded by PAD."""
    return F.pad(img[:, None], (PAD, PAD, PAD, PAD), mode="reflect")[:, 0]


def extract_patches(imp: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor) -> torch.Tensor:
    """Plain patch fetch: imp [B, Hp, Wp] padded by PAD, xs/ys [B, n] level
    coordinates -> [B*n, 48, 48] windows with the keypoint at (21, 21).
    The window start is clamped into the padded image, as in the kernel,
    so a keypoint outside the extractor's border never reads outside it."""
    B, n = xs.shape
    Hp, Wp = imp.shape[1], imp.shape[2]
    d = torch.arange(PATCH, device=imp.device)
    r0 = torch.clamp(ys + (PAD - PATCH_C), 0, Hp - PATCH)
    c0 = torch.clamp(xs + (PAD - PATCH_C), 0, Wp - PATCH)
    r = r0.reshape(-1)[:, None, None] + d[None, :, None]
    c = c0.reshape(-1)[:, None, None] + d[None, None, :]
    b = torch.arange(B, device=imp.device).repeat_interleave(n)[:, None, None]
    return imp[b, r, c]


def _pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """[K, 256] bool -> [K, 8] int32 words, bit j of word w = pair 32w + j."""
    shifts = _BIT_SHIFTS.to(bits.device)
    words = (bits.reshape(-1, 8, 32).to(torch.int64) << shifts).sum(dim=-1)
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


@functools.lru_cache(maxsize=None)
def _tables(device: str):
    """Constant tables on `device`: W2 [2304,2], band [48,42], bin_flat
    [32,512] (int64 for gather, int16 for the kernel), G7 [7], umax [16]."""
    bf = torch.from_numpy(convert.BIN_FLAT)
    return dict(
        w2=torch.from_numpy(convert.W2).to(device),
        band=torch.from_numpy(convert.BLUR_BAND).to(device),
        bin_flat=bf.to(torch.int64).to(device),
        bin_flat16=bf.to(torch.int16).to(device),
        g7=torch.from_numpy(convert.G7).to(device),
        umax=torch.from_numpy(convert.UMAX.astype(np.int32)).to(device),
    )


def features_from_patches(P: torch.Tensor):
    """P [K,48,48] raw patches -> (angle [K] float32, desc [K,8] int32).

    Intensity-centroid angle (exact atan2); 7x7 sigma=2 separable blur of
    the 42x42 interior; rBRIEF with the rotation quantized to 32 bins.
    TF32 must be off (System sets it) so the products stay float32."""
    t = _tables(str(P.device))
    K = P.shape[0]
    m = P.reshape(K, PATCH * PATCH) @ t["w2"]
    ang = torch.atan2(m[:, 1], m[:, 0])
    band = t["band"]
    blur = torch.einsum("ir,kic->krc", band, torch.einsum("kij,jc->kic", P, band))
    bf = blur.reshape(K, (PATCH - 6) ** 2)
    bins = torch.remainder(torch.round(ang * _BINS_PER_RADIAN).to(torch.int32), 32)
    vals = torch.gather(bf, 1, t["bin_flat"][bins.long()])
    return ang, _pack_bits(vals[:, :256] < vals[:, 256:])


def orb_patch_desc_plain(img: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor):
    """Plain version of K1 on one level: level images [B, h, w], keypoints
    xs/ys int32 [B, n] -> (angle [B, n], desc [B, n, 8] int32)."""
    B, n = xs.shape
    ang, desc = features_from_patches(extract_patches(pad_level(img), xs, ys))
    return ang.reshape(B, n), desc.reshape(B, n, 8)


def reflect_index(i: torch.Tensor, n: int) -> torch.Tensor:
    """Source index of index i of an axis of length n extended by
    `jnp.pad(mode="reflect")` (i in the unpadded axis' coordinates, valid
    for -n < i < 2n - 1): i < 0 -> -i, i >= n -> 2n - 2 - i. The kernel
    indexes the level the same way (`reflect` in csrc/orb_patch_desc.cu)."""
    return torch.where(i < 0, -i, torch.where(i >= n, 2 * n - 2 - i, i))


def window_index(shape, xs: torch.Tensor, ys: torch.Tensor) -> torch.Tensor:
    """Flat indices [B*n, 48, 48] into an unpadded level of `shape` [B, h, w]
    of each keypoint's window: the window that `extract_patches` reads from
    `pad_level` of the level (start clamped in padded coordinates), taken
    back into the level by `reflect_index`, as the kernel reads it."""
    B, h, w = shape
    n = xs.shape[1]
    d = torch.arange(PATCH, device=xs.device)
    r0 = torch.clamp(ys + (PAD - PATCH_C), 0, h + 2 * PAD - PATCH) - PAD
    c0 = torch.clamp(xs + (PAD - PATCH_C), 0, w + 2 * PAD - PATCH) - PAD
    r = reflect_index(r0.reshape(-1)[:, None] + d, h)
    c = reflect_index(c0.reshape(-1)[:, None] + d, w)
    b = torch.arange(B, device=xs.device).repeat_interleave(n)
    return (b[:, None, None] * h + r[:, :, None]) * w + c[:, None, :]


def orb_patch_desc_levels_plain(levels, xs_list, ys_list):
    """Plain version of the all-level K1 launch: per level, the windows by
    `window_index` and `features_from_patches`, the levels' keypoints
    side by side in slot order (see `orb_patch_desc_levels`)."""
    angs, descs = [], []
    for img, xs, ys in zip(levels, xs_list, ys_list):
        B, n = xs.shape
        ang, desc = features_from_patches(img.reshape(-1)[window_index(img.shape, xs, ys)])
        angs.append(ang.reshape(B, n))
        descs.append(desc.reshape(B, n, 8))
    return torch.cat(angs, dim=1), torch.cat(descs, dim=1)


# csrc/orb_patch_desc.cu: level descriptors in the kernel's parameter struct
MAX_LEVELS = 16


class _Level(ctypes.Structure):
    _fields_ = [
        ("img", ctypes.c_void_p), ("xs", ctypes.c_void_p), ("ys", ctypes.c_void_p),
        ("h", ctypes.c_int), ("w", ctypes.c_int), ("n", ctypes.c_int),
    ]


class _Args(ctypes.Structure):
    """`PatchArgsIn` of csrc/orb_patch_desc.cu. The launcher places each
    level's keypoints at the next free slots and sets `n_blocks` to the
    blocks it launched."""

    _fields_ = [
        ("lv", _Level * MAX_LEVELS),
        ("bin_flat", ctypes.c_void_p), ("g7", ctypes.c_void_p), ("umax", ctypes.c_void_p),
        ("angle", ctypes.c_void_p), ("desc", ctypes.c_void_p),
        ("n_levels", ctypes.c_int), ("n_images", ctypes.c_int), ("n_blocks", ctypes.c_int),
    ]


def orb_patch_desc_levels(levels, xs_list, ys_list):
    """K1 wrapper over every level of a frame: level images float32
    [B, h_l, w_l] (h_l, w_l > 24), keypoints xs_l/ys_l int32 [B, n_l] ->
    (angle [B, N] float32, desc [B, N, 8] int32), N = sum of n_l, level l's
    keypoints at slots sum(n_m, m < l) onwards. CPU tensors take the plain
    version; CUDA tensors take ONE launch of `orb_patch_desc_levels_launch`
    for every keypoint of every level, written straight into the outputs.
    A keypoint outside the extractor's 16 px border reads the window whose
    start is clamped into the padded level."""
    if not 0 < len(levels) <= MAX_LEVELS or len(xs_list) != len(levels) or len(ys_list) != len(levels):
        raise ValueError(f"orb_patch_desc_levels takes 1..{MAX_LEVELS} levels with xs and ys each")
    dev = levels[0].device
    if dev.type == "cpu":
        return orb_patch_desc_levels_plain(levels, xs_list, ys_list)
    if dev.type != "cuda":
        raise ValueError(f"orb_patch_desc_levels: unsupported device {dev}")
    B = levels[0].shape[0]
    t = _tables(str(dev))
    args = _Args(bin_flat=t["bin_flat16"].data_ptr(), g7=t["g7"].data_ptr(),
                 umax=t["umax"].data_ptr(), n_levels=len(levels), n_images=B)
    n_slots = 0
    for d, img, xs, ys in zip(args.lv, levels, xs_list, ys_list):
        shape = img.shape
        if (img.device != dev or img.dtype != torch.float32 or len(shape) != 3 or shape[0] != B
                or min(shape[1], shape[2]) <= PAD or not img.is_contiguous()):
            raise ValueError(f"orb_patch_desc_levels takes contiguous float32 [B,h,w] levels with "
                             f"h, w > {PAD} on one device, got {img.dtype} {tuple(shape)} on {img.device}")
        n = xs.shape[1] if xs.dim() == 2 else -1
        if (xs.device != dev or ys.device != dev or xs.dtype != torch.int32 or ys.dtype != torch.int32
                or xs.shape != (B, n) or ys.shape != (B, n) or not (xs.is_contiguous() and ys.is_contiguous())):
            raise ValueError("orb_patch_desc_levels: xs, ys must be contiguous int32 [B, n] on the levels' device")
        d.img, d.xs, d.ys = img.data_ptr(), xs.data_ptr(), ys.data_ptr()
        d.h, d.w, d.n = shape[1], shape[2], n
        n_slots += n
    angle = torch.empty((B, n_slots), dtype=torch.float32, device=dev)
    desc = torch.empty((B, n_slots, 8), dtype=torch.int32, device=dev)
    args.angle, args.desc = angle.data_ptr(), desc.data_ptr()
    build.launch("orb_patch_desc_levels_launch", args)
    if args.n_blocks:
        orb_patch_desc_levels.launches += 1
    return angle, desc


orb_patch_desc_levels.launches = 0


def orb_patch_desc(img: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor):
    """K1 on one level: level images [B, h, w], keypoints xs/ys int32
    [B, n] -> (angle [B, n], desc [B, n, 8] int32)."""
    return orb_patch_desc_levels([img], [xs], [ys])
