"""Carrying the JAX package's arrays across to the port.

Two kinds of things cross the boundary:

  * the ORB constant tables of `orbslam2_tpu/ops/orb.py` and
    `orbslam2_tpu/ops/fast.py` (`_PATTERN`, `_IC_MASK`, `_W2`,
    `_BLUR_BAND`, `_BIN_FLAT`, `CIRCLE`). They are built here with the same
    numpy code from the same pattern file, so the port needs no JAX to
    have them; the tests hold them equal to the JAX package's;
  * arrays: a JAX `FrameFeatures`, the argument tuple of the JAX
    tracker's `_full_step`, a point-major BA problem, a BoW `Vocabulary`
    (the "weights" of relocalization), a `Sim3` and a `PoseGraphProblem`
    become the port's tensors. Anything with `__array__` converts, so this module never
    imports JAX.

Descriptors: the JAX package keeps 256-bit descriptors as uint32 [N, 8];
the port keeps the same bits as int32 [N, 8] (`.view(np.int32)`), because
PyTorch has no popcount and no shift on uint32.
"""

from __future__ import annotations

import os

import numpy as np
import torch

# ---------------------------------------------------------------------------
# ORB constant tables (orbslam2_tpu/ops/orb.py, fast.py)
# ---------------------------------------------------------------------------

#: [256, 4] learned ORB test pattern (x1, y1, x2, y2); `ops/orb_pattern.npy`
#: is a copy of the JAX package's data file (the tests hold them equal)
PATTERN = np.load(os.path.join(os.path.dirname(__file__), "ops", "orb_pattern.npy"))

#: Bresenham circle of radius 3 (dx, dy), clockwise: the FAST-16 ring
CIRCLE = (
    (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
    (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3),
)

N_ANGLE_BINS = 32  # rBRIEF rotation quantization
PATCH = 48  # per-keypoint window: IC angle r=15 and rotated BRIEF +-18 + blur
PATCH_C = 21  # keypoint offset inside the 48x48 patch
BLUR_C = 18  # keypoint offset inside the blurred 42x42 interior


def _umax() -> np.ndarray:
    """Row extents of the radius-15 intensity-centroid disc (reference
    src/ORBextractor.cpp:391-407)."""
    hp = 15
    umax = np.zeros(hp + 1, np.int32)
    vmax = int(np.floor(hp * np.sqrt(2.0) / 2 + 1))
    vmin = int(np.ceil(hp * np.sqrt(2.0) / 2))
    for v in range(vmax + 1):
        umax[v] = int(round(np.sqrt(hp * hp - v * v)))
    v0 = 0
    for v in range(hp, vmin - 1, -1):
        while umax[v0] == umax[v0 + 1]:
            v0 += 1
        umax[v] = v0
        v0 += 1
    return umax


UMAX = _umax()


def _ic_weights():
    hp = 15
    dy, dx = np.mgrid[-hp : hp + 1, -hp : hp + 1]
    mask = np.abs(dx) <= UMAX[np.abs(dy)]
    return mask.astype(np.float32), dx.astype(np.float32), dy.astype(np.float32)


IC_MASK, IC_DX, IC_DY = _ic_weights()


def _w2() -> np.ndarray:
    """IC-angle weights embedded at the patch centre, [2304, 2] (m10, m01)."""
    wx = np.zeros((PATCH, PATCH), np.float32)
    wy = np.zeros((PATCH, PATCH), np.float32)
    sl = slice(PATCH_C - 15, PATCH_C + 16)
    wx[sl, sl] = IC_DX * IC_MASK
    wy[sl, sl] = IC_DY * IC_MASK
    return np.stack([wx.reshape(-1), wy.reshape(-1)], axis=1)


W2 = _w2()


def _gauss_kernel7() -> np.ndarray:
    x = np.arange(7) - 3
    g = np.exp(-(x**2) / (2.0 * 4.0))
    return (g / g.sum()).astype(np.float32)


G7 = _gauss_kernel7()


def _blur_band() -> np.ndarray:
    """Separable 7-tap blur as a banded [48, 42] operator."""
    band = np.zeros((PATCH, PATCH - 6), np.float32)
    for k in range(7):
        band[np.arange(PATCH - 6) + k, np.arange(PATCH - 6)] += G7[k]
    return band


BLUR_BAND = _blur_band()


def _bin_flat_indices() -> np.ndarray:
    """Rotated-pattern sample indices per angle bin, [32, 512] into the
    flattened 42x42 blurred patch (reference src/ORBextractor.cpp:45-84
    rotation convention)."""
    px = np.concatenate([PATTERN[:, 0], PATTERN[:, 2]]).astype(np.float64)
    py = np.concatenate([PATTERN[:, 1], PATTERN[:, 3]]).astype(np.float64)
    out = np.zeros((N_ANGLE_BINS, 512), np.int32)
    for i in range(N_ANGLE_BINS):
        th = 2 * np.pi * i / N_ANGLE_BINS
        a, b = np.cos(th), np.sin(th)
        cols = np.round(px * a - py * b).astype(np.int32)
        rows = np.round(px * b + py * a).astype(np.int32)
        out[i] = (rows + BLUR_C) * 42 + (cols + BLUR_C)
    return out


BIN_FLAT = _bin_flat_indices()

# ---------------------------------------------------------------------------
# arrays
# ---------------------------------------------------------------------------


def desc_to_torch(desc, device) -> torch.Tensor:
    """uint32 [..., 8] descriptor words -> int32 tensor holding the same bits."""
    a = np.ascontiguousarray(np.asarray(desc, np.uint32))
    return torch.from_numpy(a.view(np.int32).copy()).to(device)


def desc_to_numpy(desc: torch.Tensor) -> np.ndarray:
    """int32 descriptor tensor -> uint32 numpy words (the map's dtype)."""
    return np.ascontiguousarray(desc.detach().cpu().numpy()).view(np.uint32)


def to_torch(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a)).to(device)


def features_to_torch(f, device):
    """A JAX `FrameFeatures` (or any object with its fields) -> the port's
    `FrameFeatures` on `device`."""
    from .slam.frontend import FrameFeatures

    return FrameFeatures(
        uv=to_torch(f.uv, device), octave=to_torch(f.octave, device),
        angle=to_torch(f.angle, device), response=to_torch(f.response, device),
        desc=desc_to_torch(f.desc, device), valid=to_torch(f.valid, device),
        u_right=to_torch(f.u_right, device), depth=to_torch(f.depth, device),
    )


#: positions of descriptor arrays and of scalars in `_full_step`'s arguments
_FULL_STEP_DESC = (3, 12)
_FULL_STEP_FLOAT = (8, 17)
_FULL_STEP_BOOL = (9, 10)


def full_step_args_to_torch(args, device) -> tuple:
    """The JAX tracker's `_full_step` argument tuple (numpy leaves or JAX
    arrays) -> the same tuple for the port's `full_step`: arrays become
    tensors on `device`, the threshold and direction flags Python scalars."""
    out = []
    for i, a in enumerate(args):
        if i in _FULL_STEP_DESC:
            out.append(desc_to_torch(a, device))
        elif i in _FULL_STEP_FLOAT:
            out.append(float(np.asarray(a)))
        elif i in _FULL_STEP_BOOL:
            out.append(bool(np.asarray(a)))
        else:
            out.append(to_torch(a, device))
    return tuple(out)


def ba_problem_pm_to_torch(prob, device):
    """A `BAProblemPM` of numpy or JAX arrays (the JAX package's, or the
    port's assembly) -> the port's `ops.ba.BAProblemPM` on `device`, with
    int64 camera rows."""
    from .ops import ba

    t = {name: to_torch(getattr(prob, name), device) for name in ba.BAProblemPM._fields}
    t["obs_kf"] = t["obs_kf"].long()
    return ba.BAProblemPM(**t)


def vocabulary_to_torch(voc, device):
    """A JAX `Vocabulary` (or any object with its fields, numpy-convertible)
    -> the port's `vocab.bow.Vocabulary` on `device`, with the children's
    descriptor bits as int32 words."""
    from .vocab import bow

    return bow.from_arrays(voc.children_desc, voc.children_idx, voc.node_word, voc.word_weight,
                           int(voc.k), int(voc.depth), device)


def sim3_to_torch(S, device, dtype=torch.float64):
    """A JAX `Sim3` (or any (R, t, s) of numpy-convertible arrays) -> the
    port's `geometry.sim3.Sim3` of `dtype` tensors on `device`."""
    from .geometry import sim3

    return sim3.Sim3(*(torch.as_tensor(np.asarray(a), dtype=dtype, device=device) for a in S))


def pose_graph_to_torch(prob, device, dtype=torch.float64):
    """A JAX `PoseGraphProblem` (numpy-convertible leaves) -> the port's
    `ops.posegraph.PoseGraphProblem` on `device`, its Sim3s in `dtype`."""
    from .ops import posegraph

    return posegraph.PoseGraphProblem(
        vertices=sim3_to_torch(prob.vertices, device, dtype),
        edge_i=torch.as_tensor(np.asarray(prob.edge_i), dtype=torch.int64, device=device),
        edge_j=torch.as_tensor(np.asarray(prob.edge_j), dtype=torch.int64, device=device),
        meas=sim3_to_torch(prob.meas, device, dtype),
        edge_valid=torch.as_tensor(np.asarray(prob.edge_valid), dtype=torch.bool, device=device),
        fixed=torch.as_tensor(np.asarray(prob.fixed), dtype=torch.bool, device=device),
    )
