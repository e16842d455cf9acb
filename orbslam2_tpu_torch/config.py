"""Typed configuration with OpenCV-YAML compatibility.

Reads the reference's settings files (Examples/Stereo/EuRoC.yaml,
KITTI*.yaml — written for cv::FileStorage, reference src/Tracking.cpp:18-151)
unchanged: same key names (`Camera.fx`, `ORBextractor.nFeatures`, ...), so
existing dataset YAMLs drop in.

This file is a copy of orbslam2_tpu/config.py, which imports no JAX: the
port imports nothing of the JAX package, so that it runs where that
package is absent. It leaves out the one field only the JAX package reads:
`shapes` (padded buckets that keep `jax.jit` from recompiling; the port
runs eagerly and uploads tables at their true length). Merging the copies
is a roadmap item.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import yaml


@dataclass
class CameraConfig:
    fx: float = 458.654
    fy: float = 457.296
    cx: float = 367.215
    cy: float = 248.375
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0
    k3: float = 0.0
    bf: float = 47.90639384423901
    fps: float = 20.0
    rgb: int = 1
    width: int = 752
    height: int = 480


@dataclass
class OrbConfig:
    n_features: int = 1200
    scale_factor: float = 1.2
    n_levels: int = 8
    ini_th_fast: int = 20
    min_th_fast: int = 7


@dataclass
class RectifyConfig:
    """Per-eye rectification block (reference stereo_euroc.cc:75-102)."""

    K: Optional[np.ndarray] = None  # [3,3]
    D: Optional[np.ndarray] = None  # distortion
    R: Optional[np.ndarray] = None  # [3,3]
    P: Optional[np.ndarray] = None  # [3,4]
    width: int = 0
    height: int = 0


@dataclass
class SlamConfig:
    camera: CameraConfig = field(default_factory=CameraConfig)
    orb: OrbConfig = field(default_factory=OrbConfig)
    th_depth: float = 35.0  # close/far point threshold multiplier (x baseline)
    sensor: str = "stereo"  # "stereo" | "monocular"
    rectify_left: Optional[RectifyConfig] = None
    rectify_right: Optional[RectifyConfig] = None
    #: pipelined tracking: dispatch frame i's fused device step, then
    #: apply frame i-1's (already computed) results — hides the device
    #: round-trip latency behind the next frame's work. One frame of
    #: bookkeeping lag; the per-frame return value is the motion-model
    #: prediction, while the trajectory records solved poses. Off by
    #: default (the reference's per-frame API is fully synchronous).
    pipelined_tracking: bool = False
    #: adaptive gate: pipeline only while tracking support is comfortable;
    #: below this inlier count the tracker falls back to the synchronous
    #: fused step (no lag) until support recovers — the lag costs matches
    #: exactly when the map is thinnest
    pipeline_min_inliers: int = 150

    @property
    def monocular(self) -> bool:
        return self.sensor == "monocular"

    @property
    def baseline(self) -> float:
        return self.camera.bf / self.camera.fx

    @property
    def depth_threshold(self) -> float:
        """mThDepth = mbf * ThDepth / fx (reference src/Tracking.cpp:108-112)."""
        return self.camera.bf * self.th_depth / self.camera.fx

    @property
    def min_frames(self) -> int:
        return 0

    @property
    def max_frames(self) -> int:
        return int(self.camera.fps)


def _opencv_yaml_to_dict(text: str) -> dict:
    """Parse an OpenCV FileStorage YAML (%YAML:1.0 + !!opencv-matrix tags)."""
    text = re.sub(r"^%YAML:.*$", "", text, flags=re.M)
    text = text.replace("!!opencv-matrix", "")
    return yaml.safe_load(text)


def _matrix(node) -> np.ndarray:
    data = np.array(node["data"], dtype=np.float64)
    return data.reshape(int(node["rows"]), int(node["cols"]))


def load_config(path: str) -> SlamConfig:
    with open(path) as f:
        d = _opencv_yaml_to_dict(f.read())

    cam = CameraConfig(
        fx=float(d.get("Camera.fx", 458.654)),
        fy=float(d.get("Camera.fy", 457.296)),
        cx=float(d.get("Camera.cx", 367.215)),
        cy=float(d.get("Camera.cy", 248.375)),
        k1=float(d.get("Camera.k1", 0.0)),
        k2=float(d.get("Camera.k2", 0.0)),
        p1=float(d.get("Camera.p1", 0.0)),
        p2=float(d.get("Camera.p2", 0.0)),
        k3=float(d.get("Camera.k3", 0.0)),
        bf=float(d.get("Camera.bf", 47.9)),
        fps=float(d.get("Camera.fps", 20.0)),
        rgb=int(d.get("Camera.RGB", 1)),
        width=int(d.get("Camera.width", d.get("LEFT.width", 752))),
        height=int(d.get("Camera.height", d.get("LEFT.height", 480))),
    )
    orb = OrbConfig(
        n_features=int(d.get("ORBextractor.nFeatures", 1200)),
        scale_factor=float(d.get("ORBextractor.scaleFactor", 1.2)),
        n_levels=int(d.get("ORBextractor.nLevels", 8)),
        ini_th_fast=int(d.get("ORBextractor.iniThFAST", 20)),
        min_th_fast=int(d.get("ORBextractor.minThFAST", 7)),
    )
    cfg = SlamConfig(camera=cam, orb=orb, th_depth=float(d.get("ThDepth", 35.0)))

    def rect(prefix):
        if f"{prefix}.K" not in d:
            return None
        return RectifyConfig(
            K=_matrix(d[f"{prefix}.K"]),
            D=_matrix(d[f"{prefix}.D"]),
            R=_matrix(d[f"{prefix}.R"]),
            P=_matrix(d[f"{prefix}.P"]),
            width=int(d.get(f"{prefix}.width", 0)),
            height=int(d.get(f"{prefix}.height", 0)),
        )

    cfg.rectify_left = rect("LEFT")
    cfg.rectify_right = rect("RIGHT")
    return cfg
