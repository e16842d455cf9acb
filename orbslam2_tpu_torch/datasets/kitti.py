"""KITTI odometry dataset driver (reference Examples/Stereo/stereo_kitti.cc):
pre-rectified grayscale pairs in image_0/ image_1/ + times.txt.

Port of orbslam2_tpu/datasets/kitti.py; images are read by `png.py` and
returned as float32 tensors on `device`. `write_sequence` stores a stereo
sequence in this layout.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from . import png


class KittiSequence:
    def __init__(self, sequence_dir: str, device="cuda"):
        self.left_dir = os.path.join(sequence_dir, "image_0")
        self.right_dir = os.path.join(sequence_dir, "image_1")
        self.device = torch.device(device)
        with open(os.path.join(sequence_dir, "times.txt")) as f:
            self.timestamps = [float(x) for x in f.read().split()]

    def __len__(self):
        return len(self.timestamps)

    def __getitem__(self, i: int):
        name = f"{i:06d}.png"
        pair = np.stack([png.read_gray(os.path.join(d, name)) for d in (self.left_dir, self.right_dir)])
        pair = torch.from_numpy(pair).to(self.device, torch.float32)
        return pair[0], pair[1], self.timestamps[i]


def write_sequence(sequence_dir: str, pairs, timestamps):
    """Write uint8 stereo pairs as image_0/<i:06d>.png and image_1/<i:06d>.png
    under `sequence_dir`, with the timestamps (seconds) in times.txt."""
    for sub in ("image_0", "image_1"):
        os.makedirs(os.path.join(sequence_dir, sub), exist_ok=True)
    for i, (imL, imR) in enumerate(pairs):
        png.write(os.path.join(sequence_dir, "image_0", f"{i:06d}.png"), imL)
        png.write(os.path.join(sequence_dir, "image_1", f"{i:06d}.png"), imR)
    with open(os.path.join(sequence_dir, "times.txt"), "w") as f:
        f.write("".join(f"{t:.6e}\n" for t in timestamps))
