"""The port's three drivers on the CPU (`--cpu`), on short sequences written
to disk: run_euroc on 3 frames in the EuRoC layout with identity
rectification blocks, run_kitti on 3 frames in the KITTI layout,
run_synthetic on 3 rendered frames.

Stated bars: each returns 0; every frame tracked; the TUM timestamps
within 5e-4 s of the ns list; ATE RMSE < 0.06 m (the slice's bar); the
reference's output files written (a 12-column KITTI line per frame); the
usage text and return code 2 with too few arguments; `--mesh` is
refused without `--loop` (nothing else takes the mesh), and `--loop
--mesh N` fails before any work when fewer than N cards are visible, with
no fallback to the CPU. The sharded solves themselves, through the loop
closer and `System(mesh=...)`, are held in tests/test_torch_mesh_system.py.
"""

import os

import numpy as np
import pytest
import torch

from orbslam2_tpu_torch import config as C
from orbslam2_tpu_torch.datasets import euroc, kitti
from orbslam2_tpu_torch.datasets.synthetic import SyntheticWorld
from orbslam2_tpu_torch.drivers import run_euroc, run_kitti, run_synthetic
from orbslam2_tpu_torch.evaluation.ate import ate_rmse, load_tum_trajectory

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB = os.path.join(ROOT, "assets", "vocab_circuit.npz")
T0_NS = 1403636579763555584


@pytest.fixture(scope="module")
def world_frames():
    world = SyntheticWorld(n_points=900, seed=5)
    poses = world.trajectory(3, step=0.12)
    pairs = [tuple(np.clip(np.rint(im), 0, 255).astype(np.uint8) for im in world.render_stereo(T)) for T in poses]
    return world, poses, pairs


def _config(world, rectify):
    c = C.CameraConfig(fx=world.fx, fy=world.fy, cx=world.cx, cy=world.cy, bf=world.bf, width=world.width,
                       height=world.height)
    cfg = C.SlamConfig(camera=c, orb=C.OrbConfig(n_features=800))
    if rectify:
        K = np.array([[c.fx, 0, c.cx], [0, c.fy, c.cy], [0, 0, 1.0]])
        cfg.rectify_left = cfg.rectify_right = C.RectifyConfig(
            K=K, D=np.zeros((1, 5)), R=np.eye(3), P=np.concatenate([K, np.zeros((3, 1))], 1),
            width=c.width, height=c.height)
    return cfg


def _centres(poses):
    return np.stack([-T[:3, :3].T @ T[:3, 3] for T in poses])


def test_run_euroc(world_frames, tmp_path, capsys):
    world, poses, pairs = world_frames
    stamps = [T0_NS + int(round(i * 0.05e9)) for i in range(len(pairs))]
    left, right, times = euroc.write_sequence(str(tmp_path / "seq"), pairs, stamps)
    settings = str(tmp_path / "euroc.yaml")
    euroc.write_settings(settings, _config(world, rectify=True))
    out = str(tmp_path) + "/"
    assert run_euroc.main(["run_euroc", VOCAB, settings, left, right, times, out, "--cpu"]) == 0
    printed = capsys.readouterr().out
    assert f"images in sequence: {len(pairs)}" in printed and "trajectories saved" in printed
    assert "mean tracking time" in printed and "TIME STATS" in printed
    traj = load_tum_trajectory(out + "CameraTrajectory.txt")
    assert len(traj) == len(pairs)
    np.testing.assert_allclose(traj[:, 0], np.asarray(stamps, np.float64) / 1e9, rtol=0, atol=5e-4)
    assert ate_rmse(traj[:, 1:4], _centres(poses)) < 0.06
    assert len(load_tum_trajectory(out + "OfflineCameraTrajectory.txt")) == len(pairs)
    assert os.path.getsize(out + "KeyFrameTrajectory.txt") > 0
    assert run_euroc.main(["run_euroc", VOCAB]) == 2


def test_run_kitti(world_frames, tmp_path):
    world, poses, pairs = world_frames
    seq = str(tmp_path / "00")
    kitti.write_sequence(seq, pairs, [i * 0.1 for i in range(3)])
    settings = str(tmp_path / "kitti.yaml")
    euroc.write_settings(settings, _config(world, rectify=False))
    out = str(tmp_path) + "/"
    assert run_kitti.main(["run_kitti", VOCAB, settings, seq, out, "--cpu"]) == 0
    rows = np.loadtxt(out + "CameraTrajectory.txt", ndmin=2)
    assert rows.shape == (3, 12)
    tum = load_tum_trajectory(out + "CameraTrajectoryTUM.txt")
    np.testing.assert_allclose(tum[:, 0], [0.0, 0.1, 0.2], atol=1e-6)
    np.testing.assert_allclose(rows[:, [3, 7, 11]], tum[:, 1:4], atol=1e-6)
    assert ate_rmse(tum[:, 1:4], _centres(poses[:3])) < 0.06
    assert os.path.getsize(out + "OfflineCameraTrajectory.txt") > 0
    assert run_kitti.main(["run_kitti"]) == 2


def test_run_synthetic(tmp_path, capsys):
    out = str(tmp_path / "viewer")
    assert run_synthetic.main(["--frames", "3", "--cpu", "--local-mapping", "--viewer-out", out]) == 0
    printed = capsys.readouterr().out
    assert "tracked 3/3 frames" in printed and "device: cpu" in printed
    assert os.path.getsize(os.path.join(out, "map_final.png")) > 0
    with pytest.raises(SystemExit) as refused:
        run_synthetic.main(["--frames", "3", "--cpu", "--mesh", "2"])
    assert refused.value.code == 2 and "needs --loop" in capsys.readouterr().err
    n = torch.cuda.device_count()
    with pytest.raises(RuntimeError, match=f"needs {n + 1} CUDA devices; {n} visible"):
        run_synthetic.main(["--frames", "3", "--loop", "--mesh", str(n + 1)])
