"""Per-keypoint patch fetch and ORB descriptor math, and kernel K1.

Port of the JAX package's one Pallas kernel, orbslam2_tpu/ops/patches.py::
extract_patches (pallas_call at :103), fused with orbslam2_tpu/ops/orb.py::
_features_from_patches (:350-393). On the TPU the fetch needed (8, 128)
tile-aligned DMA windows and a one-hot row shift; here none of that
envelope is kept: the level image is padded by 24 px (reflect) and each
keypoint's 48x48 window is read where it lies.

`orb_patch_desc` is the extractor's entry point. On a CUDA tensor it
launches `csrc/orb_patch_desc.cu` (one block per keypoint, patch, moments,
blur and rBRIEF all in shared memory); on a CPU tensor it runs the plain
version below, which mirrors the JAX package's math (moments and blur as
float32 matrix products).
"""

from __future__ import annotations

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
    m = P.reshape(K, -1) @ t["w2"]
    ang = torch.atan2(m[:, 1], m[:, 0])
    band = t["band"]
    blur = torch.einsum("ir,kic->krc", band, torch.einsum("kij,jc->kic", P, band))
    bf = blur.reshape(K, -1)
    bins = torch.remainder(torch.round(ang * _BINS_PER_RADIAN).to(torch.int32), 32)
    vals = torch.gather(bf, 1, t["bin_flat"][bins.long()])
    return ang, _pack_bits(vals[:, :256] < vals[:, 256:])


def orb_patch_desc_plain(img: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor):
    """Plain version of K1: level images [B, h, w], keypoints xs/ys int32
    [B, n] -> (angle [B, n], desc [B, n, 8] int32)."""
    B, n = xs.shape
    ang, desc = features_from_patches(extract_patches(pad_level(img), xs, ys))
    return ang.reshape(B, n), desc.reshape(B, n, 8)


def orb_patch_desc(img: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor):
    """K1 wrapper: the plain version for CPU tensors, the CUDA kernel
    `orb_patch_desc_launch` for CUDA tensors. Keypoints must lie at least
    16 px inside the level image (the extractor's KP_BORDER)."""
    if img.device.type == "cpu":
        return orb_patch_desc_plain(img, xs, ys)
    if img.device.type != "cuda":
        raise ValueError(f"orb_patch_desc: unsupported device {img.device}")
    if img.dtype != torch.float32 or img.dim() != 3:
        raise ValueError(f"orb_patch_desc takes float32 [B,h,w], got {img.dtype} {tuple(img.shape)}")
    B, n = xs.shape
    if xs.dtype != torch.int32 or ys.dtype != torch.int32 or ys.shape != (B, n) or B != img.shape[0]:
        raise ValueError("orb_patch_desc: xs, ys must be int32 [B, n]")
    imp = pad_level(img).contiguous()
    K = B * n
    angle = torch.empty(K, dtype=torch.float32, device=img.device)
    desc = torch.empty((K, 8), dtype=torch.int32, device=img.device)
    if K:
        t = _tables(str(img.device))
        build.launch(
            "orb_patch_desc_launch", imp, xs.contiguous(), ys.contiguous(),
            t["bin_flat16"], t["g7"], t["umax"], angle, desc,
            K, n, imp.shape[1], imp.shape[2],
        )
        orb_patch_desc.launches += 1
    return angle.reshape(B, n), desc.reshape(B, n, 8)


orb_patch_desc.launches = 0
