"""Absolute trajectory error — the reference's evaluation metric.

Port of orbslam2_tpu/evaluation/ate.py (numpy only): the standard Umeyama
SE(3)/Sim(3) alignment used by the ORB-SLAM2 papers for RMSE ATE, the
reference script's mean absolute error (result_analysis.py:171-192), the
TUM trajectory reader and nearest-timestamp association. A copy, so that
the port imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np


def umeyama_alignment(src: np.ndarray, dst: np.ndarray, with_scale: bool = False):
    """Least-squares rigid (or similarity) transform aligning src -> dst.

    src, dst: [N,3]. Returns (R, t, s) such that dst ~ s*R@src + t.
    """
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    if with_scale:
        var_s = (xs**2).sum() / len(src)
        s = np.trace(np.diag(D) @ S) / var_s
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    return R, t, s


def ate_rmse(
    est_xyz: np.ndarray, gt_xyz: np.ndarray, align: bool = True, with_scale: bool = False
) -> float:
    """RMSE of translational ATE after (optional) Umeyama alignment."""
    est = np.asarray(est_xyz, np.float64)
    gt = np.asarray(gt_xyz, np.float64)
    if est.shape != gt.shape:
        raise ValueError(f"ate_rmse: shapes differ, {est.shape} vs {gt.shape}")
    if align:
        R, t, s = umeyama_alignment(est, gt, with_scale)
        est = (s * (R @ est.T)).T + t
    err = est - gt
    return float(np.sqrt((err**2).sum(axis=1).mean()))


def ate_mean_abs(est_xyz: np.ndarray, gt_xyz: np.ndarray, align: bool = True):
    """Mean absolute error + std, the reference script's reported numbers
    (result_analysis.py:171-192)."""
    est = np.asarray(est_xyz, np.float64)
    gt = np.asarray(gt_xyz, np.float64)
    if align:
        R, t, _ = umeyama_alignment(est, gt)
        est = (R @ est.T).T + t
    d = np.linalg.norm(est - gt, axis=1)
    return float(d.mean()), float(d.std())


def load_tum_trajectory(path: str) -> np.ndarray:
    """Load a TUM-format trajectory file -> [N,8] (t x y z qx qy qz qw)."""
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            vals = [float(x) for x in line.replace(",", " ").split()]
            if len(vals) >= 8:
                rows.append(vals[:8])
    return np.array(rows)


def associate_by_time(t_a: np.ndarray, t_b: np.ndarray, max_dt: float = 0.02):
    """Nearest-timestamp association: returns index pairs (ia, ib)."""
    ib = np.searchsorted(t_b, t_a)
    ib = np.clip(ib, 1, len(t_b) - 1)
    left = t_b[ib - 1]
    right = t_b[ib]
    ib = np.where(np.abs(t_a - left) < np.abs(t_a - right), ib - 1, ib)
    ok = np.abs(t_b[ib] - t_a) <= max_dt
    return np.nonzero(ok)[0], ib[ok]
