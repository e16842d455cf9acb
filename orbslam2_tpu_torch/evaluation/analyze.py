#!/usr/bin/env python
"""Trajectory analysis CLI — the reference's result_analysis.py analog.

Compares an estimated TUM trajectory against ground truth (EuRoC
state_groundtruth_estimate0 CSV or another TUM file), reports mean
absolute error / std (the reference's numbers, result_analysis.py:171-192)
and Umeyama-aligned RMSE. A copy of orbslam2_tpu/evaluation/analyze.py,
so that the port imports nothing of the JAX package, without its
`--plot` option, which draws with matplotlib.

Usage:
  python -m orbslam2_tpu_torch.evaluation.analyze EST.txt GT.(csv|txt)
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from .ate import associate_by_time, ate_mean_abs, ate_rmse, load_tum_trajectory


def load_ground_truth(path: str) -> np.ndarray:
    """EuRoC ground-truth CSV (ns timestamps) or TUM txt -> [N,8]."""
    if path.endswith(".csv"):
        rows = []
        with open(path) as f:
            for line in f:
                if line.startswith("#"):
                    continue
                v = line.strip().split(",")
                if len(v) >= 8:
                    # t[ns], p_xyz, q_wxyz -> TUM t, xyz, q_xyzw
                    rows.append(
                        [float(v[0]) / 1e9, float(v[1]), float(v[2]), float(v[3]),
                         float(v[5]), float(v[6]), float(v[7]), float(v[4])]
                    )
        return np.array(rows)
    return load_tum_trajectory(path)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("estimate")
    ap.add_argument("ground_truth")
    ap.add_argument("--max-dt", type=float, default=0.02)
    args = ap.parse_args(argv)

    est = load_tum_trajectory(args.estimate)
    gt = load_ground_truth(args.ground_truth)
    ia, ib = associate_by_time(est[:, 0], gt[:, 0], args.max_dt)
    if len(ia) < 10:
        print(f"only {len(ia)} associated poses — check timestamps")
        return 1
    e = est[ia, 1:4]
    g = gt[ib, 1:4]
    mean_abs, std = ate_mean_abs(e, g)
    rmse = ate_rmse(e, g)
    print(f"associated poses: {len(ia)}")
    print(f"mean abs trajectory error: {mean_abs:.4f} m (std {std:.4f})")
    print(f"ATE RMSE (Umeyama-aligned): {rmse:.4f} m")

    return 0


if __name__ == "__main__":
    sys.exit(main())
