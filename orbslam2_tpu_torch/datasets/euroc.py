"""EuRoC MAV dataset driver.

Port of orbslam2_tpu/datasets/euroc.py (reference Examples/Stereo/
stereo_euroc.cc): timestamp list loading (:21-41), image path
construction, and stereo rectification from the LEFT./RIGHT. K/D/R/P
blocks of the settings YAML (:75-102, cv::initUndistortRectifyMap +
cv::remap). Images are read by `png.py`; the rectification runs on the
System's device, so a rectified pair never returns to the host.
`write_sequence` and `write_settings` store a stereo sequence and its
settings in EuRoC's layout (a synthetic sequence stands in for a
dataset where none is at hand).
"""

from __future__ import annotations

import os
from typing import List

import numpy as np
import torch
import torch.nn.functional as F

from ..config import RectifyConfig, SlamConfig
from . import png


def load_timestamps(path: str) -> List[float]:
    """EuRoC_TimeStamps/*.txt: one ns timestamp per line (stereo_euroc.cc:29-40)."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(float(line) / 1e9)
    return out


def image_paths(folder: str, times_file: str) -> List[str]:
    """Image file names are <ns>.png matching the timestamp list."""
    out = []
    with open(times_file) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(os.path.join(folder, line + ".png"))
    return out


def undistort_rectify_map(block: RectifyConfig) -> np.ndarray:
    """OpenCV's initUndistortRectifyMap(K, D, R, P[:3, :3], size, CV_32F) in
    float64: [2, H, W] source coordinates (x, y) of each target pixel. For
    target pixel (u, v): x = (u - c'x) / f'x, y = (v - c'y) / f'y through
    P, [X, Y, W] = R^-1 [x, y, 1], the radial (k1, k2, k3) and tangential
    (p1, p2) distortion of (X/W, Y/W), projected through K (its skew
    ignored, as OpenCV does)."""
    K, P, R = (np.asarray(a, np.float64) for a in (block.K, block.P, block.R))
    d = np.zeros(5)
    d[:np.asarray(block.D).size] = np.asarray(block.D, np.float64).reshape(-1)[:5]
    k1, k2, p1, p2, k3 = d
    v, u = np.mgrid[0:block.height, 0:block.width].astype(np.float64)
    ray = np.stack([(u - P[0, 2]) / P[0, 0], (v - P[1, 2]) / P[1, 1], np.ones_like(u)])
    X, Y, W = np.einsum("ij,jhw->ihw", np.linalg.inv(R), ray)
    x, y = X / W, Y / W
    r2 = x * x + y * y
    radial = 1 + ((k3 * r2 + k2) * r2 + k1) * r2
    xd = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    yd = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    return np.stack([K[0, 0] * xd + K[0, 2], K[1, 1] * yd + K[1, 2]])


class Rectifier:
    """Stereo rectification (reference stereo_euroc.cc:75-105) on `device`:
    the maps are computed once in float64 and kept as float32; `__call__`
    samples both eyes in one bilinear `grid_sample` with 0 outside the
    image (cv2.remap's INTER_LINEAR and BORDER_CONSTANT), rounds to 8 bits
    as cv2.remap does for a uint8 image, and returns two float32 [H, W]
    tensors on `device`. Without the YAML blocks the pair passes through."""

    def __init__(self, config: SlamConfig, device="cuda"):
        self.device = torch.device(device)
        L, R = config.rectify_left, config.rectify_right
        self.maps = None
        if L is None or R is None:
            return
        maps = np.stack([undistort_rectify_map(L), undistort_rectify_map(R)])  # [2 eyes, 2, H, W]
        self.maps = torch.from_numpy(maps).to(self.device, torch.float32)
        # grid_sample's align_corners=True coordinates: -1 and 1 at the
        # centres of the first and last source pixels
        H, W = L.height, L.width
        scale = torch.tensor([2.0 / (W - 1), 2.0 / (H - 1)], dtype=torch.float64)
        grid = torch.from_numpy(maps).permute(0, 2, 3, 1) * scale - 1.0
        self._grid = grid.to(self.device, torch.float32)

    def __call__(self, im_left, im_right):
        pair = torch.stack([torch.as_tensor(im) for im in (im_left, im_right)]).to(self.device, torch.float32)
        if self.maps is None:
            return pair[0], pair[1]
        if pair.shape[1:] != self._grid.shape[1:3]:
            raise ValueError(f"rectifier: images {tuple(pair.shape[1:])}, maps {tuple(self._grid.shape[1:3])}")
        out = F.grid_sample(pair[:, None], self._grid, mode="bilinear", padding_mode="zeros", align_corners=True)
        out = torch.round(out[:, 0]).clamp(0, 255)
        return out[0], out[1]


class EurocSequence:
    """Rectified grayscale stereo pairs (float32 tensors on `device`) +
    timestamps."""

    def __init__(self, left_folder: str, right_folder: str, times_file: str, config: SlamConfig,
                 device="cuda"):
        self.left_paths = image_paths(left_folder, times_file)
        self.right_paths = image_paths(right_folder, times_file)
        self.timestamps = load_timestamps(times_file)
        self.rectifier = Rectifier(config, device)

    def __len__(self):
        return len(self.timestamps)

    def __getitem__(self, i: int):
        imL, imR = self.rectifier(png.read_gray(self.left_paths[i]), png.read_gray(self.right_paths[i]))
        return imL, imR, self.timestamps[i]


def write_sequence(root: str, pairs, stamps_ns) -> tuple:
    """Write uint8 stereo pairs as mav0/cam0/data/<ns>.png and
    mav0/cam1/data/<ns>.png under `root`, with the ns timestamp list
    times.txt. Returns (left folder, right folder, times file)."""
    left, right = (os.path.join(root, "mav0", cam, "data") for cam in ("cam0", "cam1"))
    for folder in (left, right):
        os.makedirs(folder, exist_ok=True)
    for (imL, imR), ns in zip(pairs, stamps_ns):
        png.write(os.path.join(left, f"{ns}.png"), imL)
        png.write(os.path.join(right, f"{ns}.png"), imR)
    times = os.path.join(root, "times.txt")
    with open(times, "w") as f:
        f.write("".join(f"{ns}\n" for ns in stamps_ns))
    return left, right, times


def _matrix(rows: int, cols: int, data) -> str:
    values = ", ".join(repr(float(x)) for x in np.asarray(data, np.float64).reshape(-1))
    return f"!!opencv-matrix\n   rows: {rows}\n   cols: {cols}\n   dt: d\n   data: [{values}]\n"


def write_settings(path: str, config: SlamConfig):
    """`config` as an OpenCV-style settings YAML with the keys of the
    reference's EuRoC.yaml (read back by `config.load_config`), with the
    LEFT./RIGHT. blocks where the config has them."""
    c, o = config.camera, config.orb
    lines = ["%YAML:1.0", ""]
    lines += [f"Camera.{k}: {getattr(c, a)!r}" for k, a in (
        ("fx", "fx"), ("fy", "fy"), ("cx", "cx"), ("cy", "cy"), ("k1", "k1"), ("k2", "k2"), ("p1", "p1"),
        ("p2", "p2"), ("k3", "k3"), ("width", "width"), ("height", "height"), ("fps", "fps"), ("bf", "bf"),
        ("RGB", "rgb"))]
    lines += [f"ThDepth: {config.th_depth!r}"]
    lines += [f"ORBextractor.{k}: {getattr(o, a)!r}" for k, a in (
        ("nFeatures", "n_features"), ("scaleFactor", "scale_factor"), ("nLevels", "n_levels"),
        ("iniThFAST", "ini_th_fast"), ("minThFAST", "min_th_fast"))]
    for name, b in (("LEFT", config.rectify_left), ("RIGHT", config.rectify_right)):
        if b is None:
            continue
        D = np.asarray(b.D, np.float64).reshape(-1)
        lines += [f"{name}.height: {b.height}", f"{name}.width: {b.width}",
                  f"{name}.D: " + _matrix(1, D.size, D), f"{name}.K: " + _matrix(3, 3, b.K),
                  f"{name}.R: " + _matrix(3, 3, b.R), f"{name}.P: " + _matrix(3, 4, b.P)]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
