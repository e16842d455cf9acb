"""Hamming distance over 256-bit ORB descriptors, and kernel K3.

Port of orbslam2_tpu/ops/hamming.py (reference ORBmatcher::
DescriptorDistance, src/ORBmatcher.cpp:1490-1508). Descriptors are int32
[N, 8] tensors holding the JAX package's uint32 bits. PyTorch has no
popcount, so the plain version counts bits with a SWAR sum on int64 (no
arithmetic shift of a negative int32 is ever taken).

`best2` is the matchers' entry point: the masked best and second-best
candidate per row. On a CUDA tensor it launches the hand-written kernel
`csrc/hamming_best2.cu`, which never materialises the [N, M] distances.
"""

from __future__ import annotations

import torch

from ..kernels import build

# Matching thresholds (reference src/ORBmatcher.cpp:8-9)
TH_LOW = 50
TH_HIGH = 100
MAX_DIST = 256  # sentinel >= any achievable distance


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Bit count of each 32-bit word of an int32 tensor, as int32."""
    v = x.to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return (((v * 0x01010101) & 0xFFFFFFFF) >> 24).to(torch.int32)


def hamming_pair(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[...,8] x [...,8] int32 -> [...] int32 Hamming distance."""
    return popcount32(torch.bitwise_xor(a, b)).sum(dim=-1, dtype=torch.int32)


def hamming_matrix(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """[N,8] x [M,8] -> [N,M] int32 all-pairs distances, word by word."""
    acc = torch.zeros((A.shape[0], B.shape[0]), dtype=torch.int32, device=A.device)
    for w in range(A.shape[-1]):
        acc += popcount32(torch.bitwise_xor(A[:, w, None], B[None, :, w]))
    return acc


def masked_argmin(dist: torch.Tensor, mask: torch.Tensor):
    """Argmin over the last axis among True mask entries: (idx, val), with
    val = MAX_DIST (and idx 0) where a row has no candidate."""
    d = torch.where(mask, dist, MAX_DIST)
    val, idx = torch.min(d, dim=-1)
    return idx.to(torch.int32), val.to(torch.int32)


def masked_two_smallest(dist: torch.Tensor, mask: torch.Tensor):
    """(best_idx, best, second_best) along the last axis under mask; the
    second best is the minimum with position best_idx set to MAX_DIST."""
    idx1, d1, _, d2 = _best2_from_dist(dist, mask)
    return idx1, d1, d2


def _best2_from_dist(dist: torch.Tensor, mask: torch.Tensor):
    d = torch.where(mask, dist, MAX_DIST).to(torch.int32)
    if d.shape[-1] == 0:
        zero = torch.zeros(d.shape[:-1], dtype=torch.int32, device=d.device)
        return zero, zero + MAX_DIST, zero, zero + MAX_DIST
    idx1 = torch.argmin(d, dim=-1)
    d1 = torch.gather(d, -1, idx1[..., None])[..., 0]
    d2m = d.scatter(-1, idx1[..., None], MAX_DIST)
    idx2 = torch.argmin(d2m, dim=-1)
    d2 = torch.gather(d2m, -1, idx2[..., None])[..., 0]
    return idx1.to(torch.int32), d1, idx2.to(torch.int32), d2


def masked_hamming(A: torch.Tensor, B: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """[N,M] int32 Hamming distances at the True entries of mask, MAX_DIST
    elsewhere; only the gated pairs are counted."""
    rows, cols = mask.nonzero(as_tuple=True)
    d = torch.full(mask.shape, MAX_DIST, dtype=torch.int32, device=A.device)
    d[rows, cols] = hamming_pair(A[rows], B[cols])
    return d


def best2_plain(A: torch.Tensor, B: torch.Tensor, mask: torch.Tensor):
    """Plain version of K3: (idx1, d1, idx2, d2) int32 [N] for the masked
    all-pairs Hamming distances (`hamming_matrix` + `masked_two_smallest`
    + the second-index pass of search_by_projection_points)."""
    return _best2_from_dist(masked_hamming(A, B, mask), mask)


def best2(A: torch.Tensor, B: torch.Tensor, mask: torch.Tensor):
    """K3 wrapper: the plain version for CPU tensors, the CUDA kernel
    `hamming_best2_launch` for CUDA tensors."""
    if A.device.type == "cpu":
        return best2_plain(A, B, mask)
    if A.device.type != "cuda":
        raise ValueError(f"best2: unsupported device {A.device}")
    N, M = A.shape[0], B.shape[0]
    if A.dtype != torch.int32 or B.dtype != torch.int32 or mask.dtype != torch.bool:
        raise TypeError("best2 takes int32 descriptors and a bool mask")
    if A.shape[1:] != (8,) or B.shape[1:] != (8,) or mask.shape != (N, M):
        raise ValueError(f"best2: bad shapes {tuple(A.shape)} {tuple(B.shape)} {tuple(mask.shape)}")
    if B.device != A.device or mask.device != A.device:
        raise ValueError("best2: tensors on different devices")
    out = [torch.empty(N, dtype=torch.int32, device=A.device) for _ in range(4)]
    if N == 0:
        return tuple(out)
    if M == 0:
        raise ValueError("best2: no candidates (M == 0)")
    A, B, mask = _aligned(A), _aligned(B), mask.contiguous()
    build.launch("hamming_best2_launch", A, B, mask, *out, N, M)
    best2.launches += 1
    return tuple(out)


best2.launches = 0


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """Contiguous with a 16-byte aligned base (the kernel reads int4 rows)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()
