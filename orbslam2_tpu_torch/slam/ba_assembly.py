"""Host-side assembly of point-major BA problems from the map.

Port of orbslam2_tpu/slam/ba_assembly.py: the map's observation lists
grouped per point into [P, D] rows, at the problem's true length (K
keyframes, P points, D = the most observations any point keeps). The JAX
package pads each axis to a power of two for `jax.jit`; padded rows carry
no valid edge, so the port leaves them out.

The observation gather is vectorized over the map's dense pt_obs mirror
(the reference's g2o assembly loops per edge, src/Optimizer.cpp:482-563):
assembly runs under the map lock while the tracker frames, so it hands
numpy arrays to the solver, which uploads them outside the lock.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from ..ops import ba
from .map import SlamMap

MAX_OBS_PER_POINT = 16  # D cap; overflow observations skip BA (kept in map)


class PMMeta:
    __slots__ = ("kf_index", "pt_index", "fixed_mask", "edge_kf", "pts", "local_kfs")

    def __init__(self, kf_index, pt_index, fixed_mask, edge_kf, pts, local_kfs):
        self.kf_index = kf_index
        self.pt_index = pt_index
        self.fixed_mask = fixed_mask
        self.edge_kf = edge_kf  # [P, D] original kf id per slot (-1 empty)
        self.pts = pts
        self.local_kfs = local_kfs


def assemble_pm_problem(
    m: SlamMap,
    frontend,
    all_kfs: List[int],
    pts: List[int],
    kf_index: Dict[int, int],
    pt_index: Dict[int, int],
    free_kfs: List[int],
):
    """Returns (BAProblemPM of numpy arrays, PMMeta), or (None, None) if
    the problem is underconstrained."""
    K, P = len(all_kfs), len(pts)
    poses = np.tile(np.eye(4, dtype=np.float32), (K, 1, 1))
    for k, i in kf_index.items():
        poses[i] = m.kf_pose[k]
    pts_arr = np.asarray(pts, np.int64)
    points = m.pt_pos[pts_arr].astype(np.float32)
    fixed_mask = np.ones(K, bool)
    for k in free_kfs:
        fixed_mask[kf_index[k]] = k == 0  # KF0 anchors the gauge
    if all(fixed_mask[kf_index[k]] for k in free_kfs):
        return None, None
    if P < 3:
        return None, None

    # --- vectorized observation gather over the dense pt_obs mirror ---
    rows_kf = m.pt_obs_kf[pts_arr]  # [P, D0] kf id per slot (-1 empty)
    rows_idx = m.pt_obs_idx[pts_arr]  # [P, D0] feature index
    # kf id -> solver row lookup (only kfs in this problem participate)
    kf_ids = np.asarray(all_kfs, np.int64)
    lut = np.full(int(kf_ids.max()) + 2 if len(kf_ids) else 1, -1, np.int64)
    lut[kf_ids] = [kf_index[int(k)] for k in kf_ids]
    in_prob = (rows_kf >= 0) & (rows_kf < len(lut))
    ki = np.where(in_prob, lut[np.clip(rows_kf, 0, len(lut) - 1)], -1)
    sel = in_prob & (ki >= 0)
    # compact selected slots to the left of each row (stable); the first
    # MAX_OBS_PER_POINT of them go into the problem
    order = np.argsort(~sel, axis=1, kind="stable")[:, :MAX_OBS_PER_POINT]
    sel_c = np.take_along_axis(sel, order, axis=1)
    n_edges = int(sel_c.sum())
    if n_edges < 10:
        return None, None
    D = int(sel_c.sum(axis=1).max())
    order, sel_c = order[:, :D], sel_c[:, :D]
    ki_c = np.take_along_axis(ki, order, axis=1)
    kf_c = np.take_along_axis(rows_kf, order, axis=1)
    idx_c = np.take_along_axis(rows_idx, order, axis=1)

    # stacked per-keyframe feature tables for one fancy-indexed gather
    N = len(m.kf_frame[int(kf_ids[0])].valid)
    uv_all = np.zeros((K, N, 2), np.float32)
    ur_all = np.full((K, N), -1.0, np.float32)
    oct_all = np.zeros((K, N), np.int32)
    for r, k in enumerate(kf_ids):
        f = m.kf_frame[int(k)]
        uv_all[r] = f.uv
        ur_all[r] = f.u_right
        oct_all[r] = f.octave
    row_lut = np.zeros(len(lut), np.int64)
    row_lut[kf_ids] = np.arange(K)
    fr = row_lut[np.clip(kf_c, 0, len(lut) - 1)]
    fi = np.clip(idx_c, 0, N - 1)

    uv_g = uv_all[fr, fi]  # [P, D, 2]
    ur_g = ur_all[fr, fi]
    obs = np.zeros((P, D, 3), np.float32)
    obs[..., 0] = np.where(sel_c, uv_g[..., 0], 0.0)
    obs[..., 1] = np.where(sel_c, uv_g[..., 1], 0.0)
    obs[..., 2] = np.where(sel_c, ur_g, 0.0)
    prob = ba.BAProblemPM(
        poses=poses,
        points=points,
        obs_kf=np.where(sel_c, ki_c, 0).astype(np.int64),
        obs=obs,
        inv_sigma2=np.where(sel_c, 1.0 / frontend.level_sigma2[oct_all[fr, fi]], 1.0).astype(np.float32),
        is_stereo=sel_c & (ur_g >= 0),
        edge_valid=sel_c,
        pose_fixed=fixed_mask,
    )
    meta = PMMeta(kf_index, pt_index, fixed_mask, np.where(sel_c, kf_c, -1), pts, free_kfs)
    return prob, meta


def apply_pm_result(m: SlamMap, res: ba.BAResultPM, meta: PMMeta):
    """Write back poses and points, erase outlier observations (reference
    Optimizer.cpp:718-760), refresh normals. One fetch per field."""
    new_poses = res.poses.cpu().numpy()
    new_points = res.points.cpu().numpy()
    inlier = res.edge_inlier.cpu().numpy()
    for k, i in meta.kf_index.items():
        if not meta.fixed_mask[i] and k in m.kf_valid:
            m.kf_pose[k] = new_poses[i]
    pt_ids = np.asarray(meta.pts, np.int64)
    alive = m.valid_mask(pt_ids)
    m.pt_pos[pt_ids[alive]] = new_points[alive].astype(np.float64)
    for r, c in zip(*np.nonzero((meta.edge_kf >= 0) & ~inlier)):
        p = meta.pts[r]
        if p in m.pt_valid:
            m.erase_observation(p, int(meta.edge_kf[r, c]))
    m.update_normals_batch(meta.pts)
