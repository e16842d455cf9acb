"""The port's viewer (`slam/viewer.py`) against the JAX package's on the
CPU, on one port System tracked over 6 frames of the synthetic world (600
features, 3 keyframes). The JAX drawers read the port's map and tracker,
which have the JAX package's attributes.

Stated bars, all exact:
  * the status line in every tracking state and mode, and the annotated
    frame, equal to the JAX `FrameDrawer`'s with its `_put_text` on its
    branch without cv2 (a blank bar), on the last tracked frame and on a
    made-up frame with overlapping boxes of other colours (the later
    feature's box wins), visual-odometry points, an outlier, an invalid
    feature and features on, beside and outside the border;
  * the snapshot's points, keyframe centres and heading ticks,
    covisibility edges (at the default weight 100 and at a threshold that
    splits the map's weights), spanning-tree and loop edges, trajectory
    and camera equal to what the JAX `MapDrawer` passes to a recording
    stand-in for matplotlib's axes;
  * each edge kind, alone, drawn in its colour over more than half the
    view's width, and not at all with the graph hidden;
  * a reset requested from the viewer's menu while a frame is being
    tracked is applied by the live loop after that frame, never inside a
    tracking call (the reference's System::Reset sets a flag that the next
    TrackStereo applies); the tracker then initializes a new map.
"""

import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

from orbslam2_tpu_torch import config as C
from orbslam2_tpu_torch.datasets.synthetic import SyntheticWorld
from orbslam2_tpu_torch.slam import viewer as viewer_mod
from orbslam2_tpu_torch.slam.system import System
from orbslam2_tpu_torch.slam.tracking import TrackingState
from orbslam2_tpu_torch.slam.viewer import FrameDrawer, MapDrawer


@pytest.fixture(scope="module")
def world_frames():
    world = SyntheticWorld(n_points=900, seed=7, baseline=0.2)
    cfg = C.SlamConfig(camera=C.CameraConfig(fx=world.fx, fy=world.fy, cx=world.cx, cy=world.cy, bf=world.bf,
                                             width=world.width, height=world.height, fps=20.0),
                       orb=C.OrbConfig(n_features=600))
    _, frames = world.render_sequence(6, step=0.25)
    return cfg, frames


@pytest.fixture(scope="module")
def run(world_frames):
    cfg, frames = world_frames
    s = System(None, cfg, device="cpu")
    for i, (imL, imR) in enumerate(frames):
        s.track_stereo(imL, imR, i / 20.0)
    assert s.map.n_keyframes() >= 3
    yield s
    s.shutdown()


@pytest.fixture
def jax_viewer(monkeypatch):
    """The JAX package's viewer and tracking modules, its status bar drawn
    as without cv2."""
    from orbslam2_tpu.slam import tracking as jax_tracking
    from orbslam2_tpu.slam import viewer as jax_viewer_mod

    def blank_bar(img, text):
        img[-18:, :] = 0

    monkeypatch.setattr(jax_viewer_mod.FrameDrawer, "_put_text", staticmethod(blank_bar))
    return jax_viewer_mod, jax_tracking


def _count(img, color):
    return int((img == np.array(color, np.uint8)).all(-1).sum())


def _wait(cond, timeout=30.0):
    t0 = time.monotonic()
    while not cond() and time.monotonic() - t0 < timeout:
        time.sleep(0.05)
    return cond()


def _as_system(run, frame, state, only_tracking=False):
    """A stand-in System whose tracker shows `frame` in `state`; the map
    and the config are `run`'s."""
    return SimpleNamespace(tracker=SimpleNamespace(last_frame=frame, state=state, only_tracking=only_tracking),
                           map=run.map, config=run.config)


def _drawn_by_both(run, jax_viewer, frame, image, state, only_tracking=False):
    """(port, JAX) FrameDrawer after update(image) on the same frame."""
    jv, jt = jax_viewer
    fd = FrameDrawer(_as_system(run, frame, state, only_tracking))
    jfd = jv.FrameDrawer(_as_system(run, frame, jt.TrackingState[state.name], only_tracking))
    fd.update(image)
    jfd.update(image)
    return fd, jfd


def test_frame_drawer_matches_jax_package(run, world_frames, jax_viewer):
    image = world_frames[1][-1][0]
    for state in TrackingState:
        for only_tracking in (False, True):
            fd, jfd = _drawn_by_both(run, jax_viewer, run.tracker.last_frame, image, state, only_tracking)
            assert fd.status_text() == jfd.status_text()
            assert (fd.n_tracked, fd.n_tracked_vo) == (jfd.n_tracked, jfd.n_tracked_vo)
    fd, jfd = _drawn_by_both(run, jax_viewer, run.tracker.last_frame, image, TrackingState.OK)
    assert "SLAM MODE" in fd.status_text()
    np.testing.assert_array_equal(fd.draw_frame(), jfd.draw_frame())

    W, H = run.config.camera.width, run.config.camera.height
    uv = np.array([[10, 10], [11, 10], [12.7, 11.2], [11, 12], [0, 0], [W - 1, H - 1], [W - 0.5, 5],
                   [-0.4, 7], [-1.5, 7], [W, 30], [40, 40], [41, 41], [300, 200], [301, 200.9]], np.float32)
    n = len(uv)
    made_up = SimpleNamespace(uv=uv, valid=np.arange(n) != n - 1,
                              point_ids=np.array([5, -1, 7, -1, 3, -1, 2, 4, -1, 6, -1, 9, 8, -1]),
                              outlier=np.isin(np.arange(n), [2, 11]),
                              temp_points={1: None, 3: None, 5: None, 10: None})
    for im in (image, None):
        fd, jfd = _drawn_by_both(run, jax_viewer, made_up, im, TrackingState.OK, only_tracking=True)
        assert fd.status_text() == jfd.status_text() and "+ VO matches: 4" in fd.status_text()
        np.testing.assert_array_equal(fd.draw_frame(), jfd.draw_frame())


class _RecordingAxes:
    """Records what the JAX MapDrawer hands matplotlib: (kind, format,
    keywords, [n, 2] x-z points)."""

    def __init__(self):
        self.calls = []

    def scatter(self, x, y, **kw):
        self.calls.append(("scatter", None, kw, np.stack([x, y], 1)))

    def plot(self, x, y, fmt=None, **kw):
        self.calls.append(("plot", fmt, kw, np.stack([np.asarray(x, np.float64), np.asarray(y, np.float64)], 1)))

    def find(self, kind, fmt=None, **kw):
        return [xy for k, f, w, xy in self.calls
                if k == kind and f == fmt and all(w.get(a) == b for a, b in kw.items())]


def _segments(pairs):
    """[n, 4] x0, z0, x1, z1 rows in lexicographic order."""
    rows = np.array([np.concatenate([a, b]) for a, b in pairs], np.float64).reshape(-1, 4)
    return rows[np.lexsort(rows.T[::-1])]


def _xz(p):
    return np.asarray(p, np.float64).reshape(-1, 3)[:, [0, 2]]


def test_map_snapshot_matches_jax_map_drawer(run, jax_viewer):
    jv, _ = jax_viewer
    m = run.map
    kfs = sorted(m.kf_valid)
    weights = sorted(w for k in kfs for nb, w in m.covis.get(k, {}).items() if nb > k)
    split = weights[len(weights) // 2]
    assert weights[0] < split <= weights[-1]
    a, b = kfs[0], kfs[-1]
    m.loop_edges[a].add(b)
    m.loop_edges[b].add(a)
    try:
        for threshold in (100, split):
            md, jmd = MapDrawer(run, covis_min_weight=threshold), jv.MapDrawer(run, covis_min_weight=threshold)
            for drawer in (md, jmd):
                drawer.set_current_camera_pose(run.tracker.last_frame.Tcw)
            snap = md.snapshot()
            ax = _RecordingAxes()
            jmd.draw_map_points(ax)
            jmd.draw_keyframes(ax)
            jmd.draw_trajectory(ax)
            jmd.draw_current_camera(ax)
            (points,) = ax.find("scatter", label="map points")
            np.testing.assert_array_equal(points, _xz(snap["points"]))
            reference = ax.find("scatter", c="#cc2222")
            assert len(reference) == (len(snap["reference"]) > 0)
            if reference:
                np.testing.assert_array_equal(reference[0], _xz(snap["reference"]))
            (centres,) = ax.find("plot", "b.")
            np.testing.assert_array_equal(centres, _xz([snap["centres"][k] for k in kfs]))
            c = {k: _xz(snap["centres"][k])[0] for k in kfs}
            np.testing.assert_array_equal(
                _segments(ax.find("plot", "b-")),
                _segments((c[k], c[k] + 0.15 * _xz(snap["heads"][k])[0]) for k in kfs))
            for fmt, kw, edges in (("g-", {}, snap["covis"]), ("-", {"c": "#006600"}, snap["tree"]),
                                   ("m-", {}, snap["loops"])):
                np.testing.assert_array_equal(_segments(ax.find("plot", fmt, **kw)),
                                              _segments((c[p], c[q]) for p, q in edges))
            assert snap["loops"] == [(a, b)] and snap["tree"] and snap["covis"]
            (trajectory,) = ax.find("plot", "r-")
            np.testing.assert_array_equal(trajectory, _xz(snap["trajectory"]))
            (camera,) = ax.find("plot", "g^")
            np.testing.assert_array_equal(camera, _xz(snap["camera"]))
        assert len(MapDrawer(run, covis_min_weight=split).snapshot()["covis"]) < len(weights)
    finally:
        m.loop_edges[a].discard(b)
        m.loop_edges[b].discard(a)


def test_render_draws_every_edge_kind(run):
    md = MapDrawer(run)
    snap = md.snapshot()
    kfs = sorted(snap["centres"])
    for kind, color in (("covis", viewer_mod._COVIS), ("tree", viewer_mod._TREE), ("loops", viewer_mod._LOOP)):
        alone = {**snap, "covis": [], "tree": [], "loops": [], kind: [(kfs[0], kfs[-1])],
                 "trajectory": np.zeros((0, 3)), "camera": None}
        assert _count(md.render(alone, show_points=False), color) > viewer_mod.MAP_SIZE // 2, kind
        assert _count(md.render(alone, show_points=False, show_graph=False), color) == 0, kind


def test_reset_requested_while_tracking_waits_for_the_frame(world_frames):
    cfg, frames = world_frames
    s = System(None, cfg, use_viewer=True, device="cpu")
    events = []
    track, reset = s.tracker.track, s.tracker.reset

    def tracked(*a, **k):
        events.append("begin")
        try:
            if events.count("begin") == 2:
                s.viewer.request_reset()
                time.sleep(0.6)  # three periods of the live loop at 5 fps
            return track(*a, **k)
        finally:
            events.append("end")

    def resetting():
        events.append(f"reset:{threading.current_thread().name}")
        reset()

    s.tracker.track, s.tracker.reset = tracked, resetting
    try:
        for i, (imL, imR) in enumerate(frames[:2]):
            s.track_stereo(imL, imR, i / 20.0)
        assert _wait(lambda: "reset:viewer" in events)
        at = events.index("reset:viewer")
        assert events[:at].count("begin") == events[:at].count("end") == 2
        assert s.map.n_keyframes() == 0
        s.track_stereo(*frames[2], 2 / 20.0)
        assert s.map.n_keyframes() == 1 and s.get_tracking_state() == TrackingState.OK
    finally:
        s.shutdown()
