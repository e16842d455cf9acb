"""Absolute trajectory error — the reference's evaluation metric.

Port of orbslam2_tpu/evaluation/ate.py::umeyama_alignment and ::ate_rmse
(numpy only; the standard Umeyama SE(3)/Sim(3) alignment used by the
ORB-SLAM2 papers for RMSE ATE). A copy, so that the port imports nothing
of the JAX package.
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
