"""The PyTorch port's `System` alone over the 40-frame synthetic sequence of
tests/test_tracking.py, on the CPU (the kernels' plain versions), with
its local mapper inline on every keyframe.

Stated bars: >= 39 of 40 frames tracked and ATE RMSE < 0.06 m (those of
tests/test_tracking.py); the four trajectory savers equal the JAX
package's savers on the same entries within 1e-6.
"""

import functools

import numpy as np
import pytest
from _torch_parity import slam_config

from orbslam2_tpu.slam import trajectory as jtraj
from orbslam2_tpu_torch import config as torch_config
from orbslam2_tpu_torch.datasets.synthetic import SyntheticWorld
from orbslam2_tpu_torch.evaluation.ate import ate_rmse
from orbslam2_tpu_torch.slam.system import System
from orbslam2_tpu_torch.slam.tracking import TrackingState

N_FRAMES = 40


def _center(T):
    return -T[:3, :3].T.astype(np.float64) @ T[:3, 3]


@pytest.fixture(scope="module")
def run():
    world = SyntheticWorld(n_points=900, seed=7, baseline=0.2)
    poses_gt, frames = world.render_sequence(N_FRAMES, step=0.06)
    system = System(None, slam_config(world, torch_config), device="cpu")
    est = [system.track_stereo(imL, imR, timestamp=i / 20.0) for i, (imL, imR) in enumerate(frames)]
    return system, poses_gt, est


def test_tracks_sequence(run):
    system, poses_gt, est = run
    assert system.get_tracking_state() == TrackingState.OK
    assert sum(T is not None for T in est) >= N_FRAMES - 1
    pairs = [(g, e) for g, e in zip(poses_gt, est) if e is not None]
    rmse = ate_rmse(np.stack([_center(e) for _, e in pairs]), np.stack([_center(g) for g, _ in pairs]))
    assert rmse < 0.06, rmse
    assert system.map.n_keyframes() >= 2
    assert len(system.map.pt_valid) > 300
    assert len(system.tracker.trajectory) == N_FRAMES
    for e in system.tracker.trajectory:
        assert e.ref_kf in system.map.kf_pose
    assert system.local_mapper.n_processed >= 2 and system.local_mapper.n_local_ba >= 1
    tracked = system.get_tracked_map_points()
    lf = system.tracker.last_frame
    assert len(tracked) > 50 and tracked == [int(p) for p in lf.point_ids if p >= 0]
    assert system.map_changed() == system.map.big_change_idx == 0
    # the reference's two front-end stages, measured on the last pair (2
    # repetitions in place of 20: the CPU's front end takes ~0.3 s)
    assert system.tracker.last_images is not None
    split = system.frontend.measure_stage_split
    system.frontend.measure_stage_split = functools.partial(split, reps=2)
    report = system.shutdown(measure_frontend_split=True)
    assert "Fused frame step" in report and "Map point creation" in report
    for name in ("ORB extraction", "Stereo matching"):
        assert name in report and len(system.timers.samples[name]) == 2


def test_trajectory_savers(run, tmp_path):
    system = run[0]
    entries = system.tracker.trajectory
    savers = {
        "tum": (system.save_trajectory_tum, jtraj.trajectory_tum(entries, system.map)),
        "offline": (system.save_offline_trajectory_tum,
                    jtraj.trajectory_tum(entries, system.map, offline=True)),
        "kf": (system.save_keyframe_trajectory_tum, jtraj.keyframe_trajectory_tum(system.map)),
        "kitti": (system.save_trajectory_kitti, jtraj.trajectory_kitti(entries, system.map)),
    }
    for name, (save, want) in savers.items():
        path = tmp_path / f"{name}.txt"
        save(str(path))
        got = path.read_text().splitlines()
        assert len(got) == len(want) > 0, name
        a = np.array([[float(x) for x in ln.split()] for ln in got])
        b = np.array([[float(x) for x in ln.split()] for ln in want])
        np.testing.assert_allclose(a, b, atol=1e-6)


def test_reset(run):
    system = run[0]
    world = SyntheticWorld(n_points=900, seed=7, baseline=0.2)
    s2 = System(None, slam_config(world, torch_config), device="cpu")
    imL, imR = world.render_stereo(world.trajectory(1)[0])
    assert s2.track_stereo(imL, imR, 0.0) is not None
    s2.reset()
    assert s2.get_tracking_state() == TrackingState.NO_IMAGES_YET
    assert s2.map.n_keyframes() == 0 and not s2.tracker.trajectory
    assert system.map.n_keyframes() >= 2  # the other system is untouched
