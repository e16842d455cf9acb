"""The port's headless viewer (`slam/viewer.py`) on the CPU, mirroring
tests/test_system.py::TestViewer and ::TestLiveViewer on one System with
`use_viewer=True` over 6 frames of the synthetic world (600 features, 3
keyframes). The JAX tests' file-size checks (matplotlib's PNGs) become
pixel checks of the numpy raster. The tests run in file order: the last
one resets the System from the menu.

Stated bars: > 50 feature pixels green; a map PNG decoded by `png.py`
equals `render_array`; hiding the points removes every point pixel;
>= 2 live renders, no live error, live_map.png written; the localization
toggle, the follow camera and the reset applied by the live loop; the
live thread joined at `shutdown`.
"""

import os
import time

import numpy as np
import pytest

from orbslam2_tpu_torch import config as C
from orbslam2_tpu_torch.datasets import png
from orbslam2_tpu_torch.datasets.synthetic import SyntheticWorld
from orbslam2_tpu_torch.slam import viewer as viewer_mod
from orbslam2_tpu_torch.slam.system import System
from orbslam2_tpu_torch.slam.viewer import FrameDrawer, MapDrawer, Viewer

GREEN = np.array([0, 255, 0], np.uint8)


def _wait(cond, timeout=30.0):
    t0 = time.monotonic()
    while not cond() and time.monotonic() - t0 < timeout:
        time.sleep(0.05)
    return cond()


def _count(img, color):
    return int((img == np.array(color, np.uint8)).all(-1).sum())


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    world = SyntheticWorld(n_points=900, seed=7, baseline=0.2)
    cfg = C.SlamConfig(camera=C.CameraConfig(fx=world.fx, fy=world.fy, cx=world.cx, cy=world.cy, bf=world.bf,
                                             width=world.width, height=world.height, fps=20.0),
                       orb=C.OrbConfig(n_features=600))
    s = System(None, cfg, use_viewer=True, device="cpu")
    s.viewer.out_dir = str(tmp_path_factory.mktemp("viewer"))
    _, frames = world.render_sequence(6, step=0.25)
    for i, (imL, imR) in enumerate(frames):
        s.track_stereo(imL, imR, i / 20.0)
    assert s.map.n_keyframes() >= 3
    yield s
    s.shutdown()


def test_map_snapshot_and_frame_drawing(run, tmp_path):
    v = Viewer(run)
    p = str(tmp_path / "map.png")
    v.save(p)
    np.testing.assert_array_equal(png.read(p), v.render_array())
    img = v.draw_frame()
    assert img is not None and img.shape == (run.config.camera.height, run.config.camera.width, 3)
    # tracked features are marked in green
    assert _count(img, GREEN) > 50


def test_frame_drawer_status_and_map_drawer(run, tmp_path):
    fd = FrameDrawer(run)
    fd.update()
    txt = fd.status_text()
    assert "SLAM MODE" in txt and "KFs:" in txt and "Matches:" in txt
    md = MapDrawer(run)
    md.set_current_camera_pose(run.tracker.last_frame.Tcw)
    full = md.render_array()
    assert _count(full, viewer_mod._POINT) > 100
    assert _count(full, viewer_mod._KEYFRAME) > 0 and _count(full, viewer_mod._TRAJECTORY) > 0
    assert _count(full, viewer_mod._CAMERA) > 0
    # toggles change the output: no points, no graph
    assert _count(md.render_array(show_points=False), viewer_mod._POINT) == 0
    no_kf = md.render_array(show_keyframes=False)
    assert _count(no_kf, viewer_mod._KEYFRAME) == 0 and _count(no_kf, viewer_mod._COVIS) == 0
    follow = md.render_array(follow=True, follow_radius=2.0)
    assert not np.array_equal(follow, full)
    p = str(tmp_path / "map_full.png")
    md.save(p)
    np.testing.assert_array_equal(png.read(p), full)


def test_live_viewer_renders_during_tracking(run):
    v = run.viewer
    assert _wait(lambda: v.n_live_renders >= 2)
    assert v.live_error is None
    assert v.latest_map is not None and v.latest_map.ndim == 3
    assert v.latest_frame is not None and _count(v.latest_frame, GREEN) > 50
    assert _wait(lambda: os.path.exists(os.path.join(v.out_dir, "live_map.png")))


def test_live_viewer_menu_controls(run):
    """The localization-mode switch, follow camera, show toggles and reset
    are applied by the live render loop (reference Viewer.cpp:46-52)."""
    v = run.viewer
    v.set_localization_mode(True)
    assert _wait(lambda: run.tracker.only_tracking), "the viewer loop must apply the menu"
    assert run.local_mapper.is_stopped()
    v.set_localization_mode(False)
    assert _wait(lambda: not run.tracker.only_tracking)
    v.set_follow_camera(True)
    v.set_show(points=False, graph=False)
    n0 = v.n_live_renders
    assert _wait(lambda: v.n_live_renders > n0 + 1)
    assert v.live_error is None
    assert _count(v.latest_map, viewer_mod._POINT) == 0
    v.request_reset()
    assert _wait(lambda: run.map.n_keyframes() == 0)
    run.shutdown()
    assert v._live_thread is None and v.live_error is None
