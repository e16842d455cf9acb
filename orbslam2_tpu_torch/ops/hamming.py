"""Hamming distance over 256-bit ORB descriptors, and kernel K3.

Port of orbslam2_tpu/ops/hamming.py (reference ORBmatcher::
DescriptorDistance, src/ORBmatcher.cpp:1490-1508). Descriptors are int32
[N, 8] tensors holding the JAX package's uint32 bits. PyTorch has no
popcount, so the plain version counts bits with a SWAR sum on int64 (no
arithmetic shift of a negative int32 is ever taken).

K3 (`csrc/hamming_best2.cu`) is the matchers' masked best and second-best
candidate per row, never materialising the [N, M] distances. It has six
modes: `best2` takes a bool [N, M] mask (search_by_bow, epipolar_match,
the monocular initialization matching);
`best2_gated` takes a `Gate`, the geometric gate of one of the three
tracking matchers or of fuse_match, or the FeatureVector-node gate of
search_by_bow_nodes, as per-row and per-column vectors, and on a CUDA
tensor evaluates it in the kernel, so no [N, M] gate is built either. Its
plain version builds the gate with `gate_mask` and takes `best2_plain`.

The launch counters are counted under a lock: the mapping worker thread
launches K3 beside the tracker.
"""

from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple, Optional

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


# ---------------------------------------------------------------------------
# the matchers' geometric gates (K3's gated modes)
# ---------------------------------------------------------------------------


class Gate(NamedTuple):
    """The gate of one matcher call as per-row and per-column vectors. Rows
    are the queries (left keypoints, projected points, a keyframe's
    features), columns the candidates (right or current keypoints, the
    other keyframe's features). The matchers compute `row_r` and
    `row_umin` with their plain expressions; the pair test is
    `gate_mask`'s, in the kernel as in the plain version. The `nodes` mode
    reads only the validity flags and the node ids."""

    mode: str  # "stereo", "frame", "points", "fuse" or "nodes"
    row_uv: Optional[torch.Tensor] = None  # [N, 2] float32
    row_r: Optional[torch.Tensor] = None  # [N] float32: band (stereo) or window half-size
    row_oct: Optional[torch.Tensor] = None  # [N] int32: left octave, source octave, predicted level
    row_valid: Optional[torch.Tensor] = None  # [N] bool
    col_uv: Optional[torch.Tensor] = None  # [M, 2] float32
    col_oct: Optional[torch.Tensor] = None  # [M] int32
    col_valid: Optional[torch.Tensor] = None  # [M] bool
    row_umin: Optional[torch.Tensor] = None  # stereo: uL - max_d
    row_ur: Optional[torch.Tensor] = None  # points, fuse: predicted right u
    col_ur: Optional[torch.Tensor] = None  # points, fuse: right u, < 0 where none
    oct_mode: str = "both"  # frame: "forward", "backward" or "both"
    col_isig: Optional[torch.Tensor] = None  # fuse: 1 / sigma^2 of the column's octave
    row_node: Optional[torch.Tensor] = None  # nodes: [N] int32 FeatureVector node, -1 for none
    col_node: Optional[torch.Tensor] = None  # nodes: [M] int32


def _window(g: Gate) -> torch.Tensor:
    du = g.col_uv[None, :, 0] - g.row_uv[:, 0, None]
    dv = g.col_uv[None, :, 1] - g.row_uv[:, 1, None]
    return (torch.abs(du) <= g.row_r[:, None]) & (torch.abs(dv) <= g.row_r[:, None])


def _gate_stereo(g: Gate) -> torch.Tensor:
    """stereo_match: row band, octave +-1, uL - max_d <= uR <= uL."""
    band = torch.abs(g.col_uv[None, :, 1] - g.row_uv[:, 1, None]) <= g.row_r[:, None]
    octave_ok = torch.abs(g.col_oct[None, :] - g.row_oct[:, None]) <= 1
    uR = g.col_uv[None, :, 0]
    disp_ok = (uR >= g.row_umin[:, None]) & (uR <= g.row_uv[:, 0, None])
    return band & octave_ok & disp_ok & g.row_valid[:, None] & g.col_valid[None, :]


def _gate_frame(g: Gate) -> torch.Tensor:
    """search_by_projection_frame: window, forward/backward octave gate."""
    oc, ol = g.col_oct[None, :], g.row_oct[:, None]
    if g.oct_mode == "forward":
        oct_gate = oc >= ol
    elif g.oct_mode == "backward":
        oct_gate = oc <= ol
    else:
        oct_gate = (oc >= ol - 1) & (oc <= ol + 1)
    return _window(g) & oct_gate & g.row_valid[:, None] & g.col_valid[None, :]


def _gate_points(g: Gate) -> torch.Tensor:
    """search_by_projection_points: window, octave in [pred-1, pred],
    stereo right-coordinate agreement."""
    oc, pl = g.col_oct[None, :], g.row_oct[:, None]
    oct_gate = (oc >= pl - 1) & (oc <= pl)
    has_stereo = g.col_ur[None, :] >= 0
    er = torch.abs(g.col_ur[None, :] - g.row_ur[:, None])
    stereo_gate = torch.where(has_stereo, er <= g.row_r[:, None], True)
    return _window(g) & oct_gate & stereo_gate & g.row_valid[:, None] & g.col_valid[None, :]


def _gate_fuse(g: Gate) -> torch.Tensor:
    """fuse_match: window, octave in [pred-1, pred], and the reprojection
    chi2 ((du*du + dv*dv) + er*er) * isig <= 7.8 where the keypoint has a
    right u, else (du*du + dv*dv) * isig <= 5.99 (the kernel computes the
    same float32 operations in this order, without contraction)."""
    du = g.col_uv[None, :, 0] - g.row_uv[:, 0, None]
    dv = g.col_uv[None, :, 1] - g.row_uv[:, 1, None]
    oc, pl = g.col_oct[None, :], g.row_oct[:, None]
    oct_gate = (oc >= pl - 1) & (oc <= pl)
    er = g.row_ur[:, None] - g.col_ur[None, :]
    e2_mono = du * du + dv * dv
    e2_stereo = e2_mono + er * er
    isig = g.col_isig[None, :]
    chi_ok = torch.where(g.col_ur[None, :] >= 0, e2_stereo * isig <= 7.8, e2_mono * isig <= 5.99)
    return _window(g) & oct_gate & chi_ok & g.row_valid[:, None] & g.col_valid[None, :]


def _gate_nodes(g: Gate) -> torch.Tensor:
    """search_by_bow_nodes: both valid, the same vocabulary node, >= 0."""
    same = (g.row_node[:, None] == g.col_node[None, :]) & (g.row_node >= 0)[:, None]
    return g.row_valid[:, None] & g.col_valid[None, :] & same


_GATES = {"stereo": _gate_stereo, "frame": _gate_frame, "points": _gate_points, "fuse": _gate_fuse,
          "nodes": _gate_nodes}


def gate_mask(g: Gate) -> torch.Tensor:
    """The plain [N, M] bool gate of `g` (the matchers' gate expressions)."""
    return _GATES[g.mode](g)


def best2_gated_plain(A: torch.Tensor, B: torch.Tensor, g: Gate):
    """Plain version of K3's gated modes: `best2_plain` under `gate_mask`."""
    return best2_plain(A, B, gate_mask(g))


# the gated modes' counting sort: v buckets, and the relative part of the
# slack around a row's band, far above float32's rounding of v +- r at any
# magnitude (the kernel's NB and 0x1p-16f)
N_BUCKETS = 1024
RANGE_SLACK_REL = 2.0**-16


def _bucket(v: torch.Tensor, v0, scale) -> torch.Tensor:
    x = torch.floor((v - v0) * scale)
    return torch.nan_to_num(x, nan=0.0).clamp(0, N_BUCKETS - 1).to(torch.int64)


def candidate_buckets(g: Gate):
    """The gated kernel's candidate rule, for the tests: (bucket of each
    column, -1 for a column no gate can pass (invalid, or v NaN); first and
    last bucket each row scans, last < first for an empty row). Buckets
    split the finite v range of those columns into N_BUCKETS; a row scans
    the buckets of [v - r - slack, v + r + slack], slack = 1 + (|v| + r)
    2^-16, nothing if it is invalid or that band is NaN. Mirrors
    `bucket_sort` and the row search of `hamming_best2_kernel` in float32;
    every pair the gate keeps lies inside."""
    cv = g.col_uv[:, 1]
    placed = g.col_valid & ~torch.isnan(cv)
    finite = cv[placed & torch.isfinite(cv)]
    v0 = finite.min() if finite.numel() else torch.tensor(0.0)
    span = finite.max() - v0 if finite.numel() else torch.tensor(0.0)
    ok_span = bool(span > 0) and bool(torch.isfinite(span))
    scale = torch.tensor(float(N_BUCKETS)) / span if ok_span else torch.tensor(0.0)
    col_bucket = torch.where(placed, _bucket(cv, v0, scale), -1)
    v, r = g.row_uv[:, 1], g.row_r
    slack = 1.0 + (torch.abs(v) + r) * RANGE_SLACK_REL
    lo, hi = v - r - slack, v + r + slack
    scanned = g.row_valid & (lo <= hi)
    first = torch.where(scanned, _bucket(lo, v0, scale), 0)
    last = torch.where(scanned, _bucket(hi, v0, scale), -1)
    return col_bucket, first, last


# ---------------------------------------------------------------------------
# K3 wrappers
# ---------------------------------------------------------------------------

_MODES = {"mask": 0, "stereo": 1, "frame": 2, "points": 3, "fuse": 4, "nodes": 5}
_OCT_MODES = {"forward": 0, "backward": 1, "both": 2}
_PTRS = (
    "a", "b", "mask", "row_uv", "row_r", "row_umin", "row_ur", "row_oct", "row_valid", "col_uv",
    "col_ur", "col_oct", "col_valid", "col_isig", "row_node", "col_node", "col_perm", "out",
)
#: the gated modes sort their columns in shared memory, 4 bytes per column
MAX_COLUMNS = 16384


class _Args(ctypes.Structure):
    """`Best2Args` of csrc/hamming_best2.cu: the kernel's parameter struct.
    The launcher sets `n_blocks` to the blocks it launched."""

    _fields_ = [(name, ctypes.c_void_p) for name in _PTRS] + [
        (name, ctypes.c_int) for name in ("n", "m", "mode", "oct_mode", "n_blocks")
    ]


def _device(A: torch.Tensor, name: str) -> torch.device:
    """A's device for a kernel launch; raises on a device other than CUDA."""
    if A.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {A.device}")
    return A.device


def _launch(mode: str, A, B, tensors: dict, oct_mode: str = "both"):
    """One K3 launch; tensors maps Best2Args pointer names to tensors that
    the caller has checked. Returns (idx1, d1, idx2, d2) int32 [N] views of
    one [4, N] output."""
    N, M = A.shape[0], B.shape[0]
    if A.dtype != torch.int32 or B.dtype != torch.int32 or A.shape[1:] != (8,) or B.shape[1:] != (8,):
        raise ValueError(f"K3 takes int32 [N, 8] descriptors, got {A.dtype} {tuple(A.shape)}, "
                         f"{B.dtype} {tuple(B.shape)}")
    if B.device != A.device:
        raise ValueError("K3: tensors on different devices")
    out = torch.empty((4, N), dtype=torch.int32, device=A.device)
    A, B = _aligned(A), _aligned(B)
    args = _Args(a=A.data_ptr(), b=B.data_ptr(), out=out.data_ptr(), n=N, m=M, mode=_MODES[mode],
                 oct_mode=_OCT_MODES[oct_mode])
    if mode == "nodes":
        # the kernel binary-searches the column node ids: sorted on the
        # device, with the column of each sorted slot
        nodes, perm = torch.sort(tensors["col_node"])
        perm = perm.to(torch.int32)
        tensors = dict(tensors, col_node=nodes, col_perm=perm)
    for name, t in tensors.items():
        setattr(args, name, t.data_ptr())
    build.launch("hamming_best2_launch", args)
    return tuple(out.unbind(0)), args.n_blocks > 0


_count_lock = threading.Lock()


def _count(counts: dict, key: str, launched: bool):
    with _count_lock:
        counts[key] = counts.get(key, 0) + launched


def best2(A: torch.Tensor, B: torch.Tensor, mask: torch.Tensor, caller: str = "search_by_bow"):
    """K3 in mask mode: the plain version for CPU tensors, one launch of
    `hamming_best2_launch` for CUDA tensors, counted under `caller` (the
    tracker's search_by_bow, the mapper's epipolar_match, the
    relocalizer's search_by_bow, or the monocular tracker's initialization
    matching, `mono_init`). A row with no
    candidate, and every row when M == 0, answers (0, 256, 0, 256)."""
    if A.device.type == "cpu":
        return best2_plain(A, B, mask)
    dev = _device(A, "best2")
    N, M = A.shape[0], B.shape[0]
    if mask.dtype != torch.bool or mask.shape != (N, M) or mask.device != dev:
        raise ValueError(f"best2: mask must be bool [{N}, {M}] on {dev}, got {mask.dtype} "
                         f"{tuple(mask.shape)} on {mask.device}")
    out, launched = _launch("mask", A, B, {"mask": mask.contiguous()})
    _count(best2.launches, caller, launched)
    return out


#: launches per caller
best2.launches = {"search_by_bow": 0, "epipolar_match": 0, "relocalization": 0, "mono_init": 0}


def best2_gated(A: torch.Tensor, B: torch.Tensor, g: Gate, caller: Optional[str] = None):
    """K3 in a gated mode (`g.mode`): rows A [N, 8] against columns B
    [M, 8] under the gate `g`. CPU tensors take `best2_gated_plain`; CUDA
    tensors take one launch of `hamming_best2_launch` (which sorts the
    columns by v, or by node, itself), with no [N, M] tensor. The launch
    is counted under the mode, or under "mode:caller" when `caller` is
    given (the loop closer's `fuse` calls)."""
    if A.device.type == "cpu":
        return best2_gated_plain(A, B, g)
    _device(A, "best2_gated")
    out, launched = _launch_gated(A, B, g)
    _count(best2_gated.launches, g.mode if caller is None else f"{g.mode}:{caller}", launched)
    return out


#: launches per gated mode, or per mode and caller: the loop closer's
#: `nodes` calls and its `fuse` calls (Sim3 search, loop fusion)
best2_gated.launches = {"stereo": 0, "frame": 0, "points": 0, "fuse": 0, "nodes:loop": 0,
                        "fuse:sim3": 0, "fuse:loop_fusion": 0}


def _launch_gated(A: torch.Tensor, B: torch.Tensor, g: Gate):
    """`best2_gated`'s launch: checks the gate's vectors and launches the
    mode (see `_launch`)."""
    dev, N, M = A.device, A.shape[0], B.shape[0]
    if M > MAX_COLUMNS:
        raise ValueError(f"best2_gated takes at most {MAX_COLUMNS} columns, got {M}")
    want = {"row_valid": (torch.bool, (N,)), "col_valid": (torch.bool, (M,))}
    if g.mode == "nodes":
        want.update(row_node=(torch.int32, (N,)), col_node=(torch.int32, (M,)))
    else:
        want.update(row_uv=(torch.float32, (N, 2)), row_r=(torch.float32, (N,)),
                    row_oct=(torch.int32, (N,)), col_uv=(torch.float32, (M, 2)),
                    col_oct=(torch.int32, (M,)))
    if g.mode == "stereo":
        want["row_umin"] = (torch.float32, (N,))
    elif g.mode in ("points", "fuse"):
        want["row_ur"] = (torch.float32, (N,))
        want["col_ur"] = (torch.float32, (M,))
        if g.mode == "fuse":
            want["col_isig"] = (torch.float32, (M,))
    elif g.mode not in ("frame", "nodes"):
        raise ValueError(f"best2_gated: unknown mode {g.mode!r}")
    tensors = {}
    for name, (dtype, shape) in want.items():
        t = getattr(g, name)
        if t is None or t.dtype != dtype or tuple(t.shape) != shape or t.device != dev:
            got = None if t is None else f"{t.dtype} {tuple(t.shape)} on {t.device}"
            raise ValueError(f"best2_gated ({g.mode}): {name} must be {dtype} {shape} on {dev}, got {got}")
        tensors[name] = t.contiguous()
    return _launch(g.mode, A, B, tensors, g.oct_mode)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """Contiguous with a 16-byte aligned base (the kernel reads int4 rows)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()
