"""Trajectory export: TUM / KITTI / offline formats.

Port of orbslam2_tpu/slam/trajectory.py; only the quaternion comes from
the port's `geometry/se3.py`.

Exact re-implementation of the reference savers:
  * SaveTrajectoryTUM (src/System.cpp:264-294): per-frame online poses,
    `t x y z qx qy qz qw`, resolving each stored relative pose against the
    (possibly BA-updated) reference keyframe, walking culled keyframes up
    the spanning tree via their stored parent-relative pose.
  * SaveOfflineTrajectoryTUM (src/System.cpp:296-362): same resolution but
    relative to the FIRST keyframe's current pose (post-BA / post-loop map
    frame).
  * SaveKeyFrameTrajectoryTUM (src/System.cpp:364-397).
  * SaveTrajectoryKITTI (src/System.cpp:399-455): 3x4 row-major poses.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..geometry import se3
from .map import SlamMap
from .tracking import TrajectoryEntry


def _rot_to_quat(R: np.ndarray) -> np.ndarray:
    """Rotation -> (qx, qy, qz, qw) through the port's se3 (float32, like
    the JAX package's savers)."""
    return se3.to_quaternion(torch.tensor(R[None], dtype=torch.float32))[0].numpy()


def _resolve_reference(slam_map: SlamMap, kf: int):
    """Walk culled reference keyframes up the spanning tree, accumulating
    the stored parent-relative poses (reference System.cpp:335-350)."""
    Trw = np.eye(4, dtype=np.float64)
    while kf not in slam_map.kf_valid:
        if kf not in slam_map.Tcp:
            break
        Trw = Trw @ slam_map.Tcp[kf].astype(np.float64)
        kf = slam_map.parent.get(kf, 0)
    Trw = Trw @ slam_map.kf_pose[kf].astype(np.float64)
    return Trw


def trajectory_tum(
    entries: List[TrajectoryEntry], slam_map: SlamMap, offline: bool = False
) -> List[str]:
    """Render TUM lines. online: camera pose in the original world frame.
    offline: relative to the first keyframe's CURRENT (optimized) pose."""
    lines = []
    if offline:
        first_kf = slam_map.keyframe_origins[0] if slam_map.keyframe_origins else 0
        Two = np.linalg.inv(_resolve_reference(slam_map, first_kf))
    for e in entries:
        if e.lost and e.Tcw is None:
            continue
        Trw = _resolve_reference(slam_map, e.ref_kf)
        Tcw = e.Tcr.astype(np.float64) @ Trw
        if offline:
            Tcw = Tcw @ Two
        Twc = np.linalg.inv(Tcw)
        q = _rot_to_quat(Twc[:3, :3])
        t = Twc[:3, 3]
        lines.append(
            f"{e.timestamp:.6f} {t[0]:.9f} {t[1]:.9f} {t[2]:.9f} "
            f"{q[0]:.9f} {q[1]:.9f} {q[2]:.9f} {q[3]:.9f}"
        )
    return lines


def keyframe_trajectory_tum(slam_map: SlamMap) -> List[str]:
    lines = []
    for kf in sorted(slam_map.kf_valid):
        Twc = np.linalg.inv(slam_map.kf_pose[kf].astype(np.float64))
        q = _rot_to_quat(Twc[:3, :3])
        t = Twc[:3, 3]
        ts = slam_map.kf_timestamp[kf]
        lines.append(
            f"{ts:.6f} {t[0]:.9f} {t[1]:.9f} {t[2]:.9f} "
            f"{q[0]:.9f} {q[1]:.9f} {q[2]:.9f} {q[3]:.9f}"
        )
    return lines


def trajectory_kitti(entries: List[TrajectoryEntry], slam_map: SlamMap) -> List[str]:
    lines = []
    for e in entries:
        Trw = _resolve_reference(slam_map, e.ref_kf)
        Tcw = e.Tcr.astype(np.float64) @ Trw
        Twc = np.linalg.inv(Tcw)
        R, t = Twc[:3, :3], Twc[:3, 3]
        vals = []
        for i in range(3):
            vals += [R[i, 0], R[i, 1], R[i, 2], t[i]]
        lines.append(" ".join(f"{v:.9e}" for v in vals))
    return lines


def save_lines(path: str, lines: List[str]):
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
