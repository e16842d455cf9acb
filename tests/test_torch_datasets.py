"""The port's disk path against OpenCV and the JAX package's readers, on the
CPU: the PNG codec (`datasets/png.py`), the rectifier and the EuRoC and
KITTI sequences (`datasets/euroc.py`, `datasets/kitti.py`).

Stated bars: the decoder equals `cv2.imread(..., IMREAD_GRAYSCALE)` exactly
on gray files and within 1 gray level on colour files, written by cv2 at
compression levels 0, 1, 6 and 9 and by the port's writer; the
rectifier's maps are within 1e-3 px of cv2's CV_32F maps, and against
`cv2.remap` >= 99% of interior pixels are within 1 gray level and none is
off by more than 4 (cv2 quantises the sample position to 1/32 px; the
largest difference measured is 1); the sequences' timestamps and paths
equal the JAX package's, and their pairs equal the JAX package's on
identity rectification.
"""

import os
import struct
import zlib

import cv2
import numpy as np
import pytest
import torch

from orbslam2_tpu import config as jconfig
from orbslam2_tpu.datasets import euroc as jeuroc
from orbslam2_tpu.datasets import kitti as jkitti
from orbslam2_tpu_torch import config as C
from orbslam2_tpu_torch.datasets import euroc, kitti, png
from orbslam2_tpu_torch.datasets.synthetic import SyntheticWorld


@pytest.fixture(scope="module")
def images():
    world = SyntheticWorld(n_points=900, seed=7, baseline=0.2)
    pairs = [tuple(np.clip(np.rint(im), 0, 255).astype(np.uint8) for im in world.render_stereo(T))
             for T in world.trajectory(3, step=0.1)]
    gray = pairs[0][0]
    color = np.stack([gray, np.roll(gray, 7, axis=1), 255 - pairs[0][1]], -1)
    return pairs, gray, color


def test_decoder_equals_cv2(images, tmp_path):
    _, gray, color = images
    for level in (0, 1, 6, 9):
        alpha = np.random.default_rng(level).integers(0, 256, gray.shape, dtype=np.uint8)
        for name, img in (("gray", gray), ("bgr", color), ("bgra", np.dstack([color, alpha])),
                          ("gray_alpha", np.dstack([gray, alpha]))):
            path = str(tmp_path / f"{name}{level}.png")
            if name == "gray_alpha":  # cv2 writes no gray + alpha: rows filtered None
                _write_raw(path, img, color_type=4)
            else:
                assert cv2.imwrite(path, img, [cv2.IMWRITE_PNG_COMPRESSION, level])
            got, want = png.read_gray(path), cv2.imread(path, cv2.IMREAD_GRAYSCALE)
            assert got.dtype == np.uint8 and got.shape == want.shape
            err = int(np.abs(got.astype(int) - want).max())
            assert err <= (0 if name.startswith("gray") else 1), (name, level, err)


def test_writer_round_trips_and_unsupported_files_raise(images, tmp_path):
    """The writer's gray and RGB files read back (by both decoders); a
    16-bit, palette, interlaced or non-PNG file raises naming the file."""
    _, gray, color = images
    for img in (gray, color):
        path = str(tmp_path / "mine.png")
        png.write(path, img)
        np.testing.assert_array_equal(png.read(path), img)
        want = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        np.testing.assert_array_equal(want if img.ndim == 2 else want[..., ::-1], img)
    assert int(np.abs(png.read_gray(path).astype(int) - cv2.imread(path, cv2.IMREAD_GRAYSCALE)).max()) <= 1
    with pytest.raises(ValueError, match="uint8"):
        png.write(path, gray.astype(np.float32))
    img = np.arange(64, dtype=np.uint8).reshape(8, 8)
    for kind in ("16-bit", "palette", "interlaced", "not a png"):
        path = str(tmp_path / f"{kind}.png")
        if kind == "16-bit":
            assert cv2.imwrite(path, img.astype(np.uint16) * 257)
        elif kind == "palette":
            _write_raw(path, img, color_type=3)
        elif kind == "interlaced":
            _write_raw(path, img, color_type=0, interlace=1)
        else:
            with open(path, "wb") as f:
                f.write(b"GIF89a")
        with pytest.raises(ValueError, match=path):
            png.read_gray(path)


def _write_raw(path, img, color_type, depth=8, interlace=0):
    """A PNG of `img`'s bytes under the given header fields, every row
    filtered None."""
    H, W = img.shape[:2]
    raw = np.concatenate([np.zeros((H, 1), np.uint8), img.reshape(H, -1).view(np.uint8)], 1)
    header = struct.pack(">IIBBBBB", W, H, depth, color_type, 0, 0, interlace)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + png._chunk(b"IHDR", header)
                + png._chunk(b"IDAT", zlib.compress(raw.tobytes())) + png._chunk(b"IEND", b""))


def _blocks():
    """Real rectification blocks: EuRoC cam0's K and k1, k2, p1, p2 (k3 = 0),
    a 0.5 degree rotation, P of f 435.2 and c (367.45, 252.2); the right
    eye's P has Tx = -47.9."""
    c = C.CameraConfig()
    K = np.array([[c.fx, 0, c.cx], [0, c.fy, c.cy], [0, 0, 1.0]])
    D = np.array([[-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05, 0.0]])
    R = cv2.Rodrigues(np.array([0.3, 0.8, 0.2]) / np.linalg.norm([0.3, 0.8, 0.2]) * np.deg2rad(0.5))[0]
    P = np.array([[435.2, 0, 367.45, 0], [0, 435.2, 252.2, 0], [0, 0, 1, 0]])
    PR = P.copy()
    PR[0, 3] = -47.9
    return [C.RectifyConfig(K=K, D=D, R=R, P=p, width=c.width, height=c.height) for p in (P, PR)]


def test_rectifier_equals_cv2(images):
    pairs = images[0]
    L, R = _blocks()
    rect = euroc.Rectifier(C.SlamConfig(rectify_left=L, rectify_right=R), "cpu")
    out = rect(*pairs[1])
    for eye, block in enumerate((L, R)):
        m1, m2 = cv2.initUndistortRectifyMap(block.K, block.D, block.R, block.P[:3, :3],
                                             (block.width, block.height), cv2.CV_32F)
        mine = rect.maps[eye].numpy()
        assert max(np.abs(mine[0] - m1).max(), np.abs(mine[1] - m2).max()) <= 1e-3
        want = cv2.remap(pairs[1][eye], m1, m2, cv2.INTER_LINEAR).astype(np.float32)
        got = out[eye].numpy()
        assert got.dtype == np.float32 and np.array_equal(got, np.rint(got))
        interior = (m1 >= 1) & (m1 <= block.width - 2) & (m2 >= 1) & (m2 <= block.height - 2)
        diff = np.abs(got - want)[interior]
        assert (diff <= 1).mean() >= 0.99 and diff.max() <= 4, (eye, (diff <= 1).mean(), diff.max())
    # without the blocks the pair passes through
    imL, imR = pairs[0]
    outL, _ = euroc.Rectifier(C.SlamConfig(), "cpu")(imL, imR)
    assert outL.dtype == torch.float32 and torch.equal(outL, torch.from_numpy(imL).float())


def _identity_settings(path, world, n_features=1200):
    c = C.CameraConfig(fx=world.fx, fy=world.fy, cx=world.cx, cy=world.cy, bf=world.bf, width=world.width,
                       height=world.height)
    K = np.array([[c.fx, 0, c.cx], [0, c.fy, c.cy], [0, 0, 1.0]])
    eye = C.RectifyConfig(K=K, D=np.zeros((1, 5)), R=np.eye(3), P=np.concatenate([K, np.zeros((3, 1))], 1),
                          width=c.width, height=c.height)
    cfg = C.SlamConfig(camera=c, orb=C.OrbConfig(n_features=n_features), rectify_left=eye, rectify_right=eye)
    euroc.write_settings(path, cfg)
    return cfg


def test_sequences_equal_jax(images, tmp_path):
    pairs = images[0]
    world = SyntheticWorld(n_points=10, seed=7, baseline=0.2)
    stamps = [1403636579763555584 + int(round(i * 0.05e9)) for i in range(len(pairs))]
    left, right, times = euroc.write_sequence(str(tmp_path / "euroc"), pairs, stamps)
    settings = str(tmp_path / "euroc.yaml")
    cfg = _identity_settings(settings, world)
    # the settings file reads back as written, in both packages
    back, jback = C.load_config(settings), jconfig.load_config(settings)
    assert back.camera == cfg.camera and back.orb == cfg.orb
    for a, b in ((back.rectify_left, cfg.rectify_left), (jback.rectify_right, cfg.rectify_right)):
        for name in ("K", "R", "P"):
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    seq = euroc.EurocSequence(left, right, times, back, "cpu")
    jseq = jeuroc.EurocSequence(left, right, times, jback)
    assert (seq.left_paths, seq.right_paths, seq.timestamps) == (jseq.left_paths, jseq.right_paths,
                                                                 jseq.timestamps)
    assert len(seq) == len(jseq) == len(pairs)
    for i in range(len(seq)):
        imL, imR, t = seq[i]
        jL, jR, jt = jseq[i]
        assert t == jt
        for got, want, written in ((imL, jL, pairs[i][0]), (imR, jR, pairs[i][1])):
            np.testing.assert_array_equal(got.numpy(), want)
            np.testing.assert_array_equal(got.numpy(), written.astype(np.float32))

    kdir = str(tmp_path / "kitti")
    kitti.write_sequence(kdir, pairs, [i * 0.1 for i in range(len(pairs))])
    kseq, jkseq = kitti.KittiSequence(kdir, "cpu"), jkitti.KittiSequence(kdir)
    assert kseq.timestamps == jkseq.timestamps and (kseq.left_dir, kseq.right_dir) == (jkseq.left_dir,
                                                                                        jkseq.right_dir)
    for i in range(len(kseq)):
        for got, want in zip(kseq[i], jkseq[i]):
            np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    assert os.path.exists(os.path.join(kdir, "image_1", "000002.png"))
