"""Visualization: Viewer / FrameDrawer / MapDrawer.

Port of orbslam2_tpu/slam/viewer.py (reference src/Viewer.cpp:32-113 menu
and render loop, src/FrameDrawer.cpp, src/MapDrawer.cpp), headless: both
views render to RGB uint8 arrays and PNG files (`datasets/png.py`), with
the same content and public methods as the JAX package's viewer.

  * ``FrameDrawer.update(image)`` snapshots the current frame on the
    caller's thread (FrameDrawer::Update): the image and the keypoints'
    host arrays are copied, so that drawing never races tracking and never
    touches the device. ``draw_frame()`` returns the annotated image:
    tracked map points green, visual-odometry points blue, untracked gray.
    There is no font renderer without OpenCV, so the status bar is blank,
    as the JAX package draws it without cv2; ``status_text()`` is its text
    (FrameDrawer::DrawTextInfo).
  * ``MapDrawer`` draws the top view (x right, z up) into a numpy raster:
    map points gray and the tracker's local points red (DrawMapPoints),
    keyframes as blue dots with a heading tick, the covisibility edges of
    weight >= 100 green, the spanning tree dark green and loop edges
    magenta (DrawKeyFrames / DrawGraph), the trajectory red and the
    current camera as a green triangle (DrawCurrentCamera). Lines are
    clipped to the raster and drawn by a vectorised DDA. The view fits
    everything drawn, or with `follow` a window of `follow_radius` metres
    around the current camera (menuFollowCamera, Viewer.cpp:73-81).
  * ``Viewer`` runs the menu toggles (Viewer.cpp:46-52) and a live thread
    (``run_live``) that renders both views at ~fps into `latest_frame` and
    `latest_map` (and live_frame.png / live_map.png with `out_dir`). It
    copies the map's host arrays under the map lock and renders outside
    it. A render error ends the thread; ``stop_live`` raises it.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Optional

import numpy as np
import torch

from ..datasets import png

_GREEN = (0, 255, 0)
_BLUE = (80, 160, 255)
_GRAY = (90, 90, 90)
# the map view's colours: the JAX package's matplotlib colours
_WHITE = (255, 255, 255)
_POINT = (153, 153, 153)
_REFERENCE = (204, 34, 34)
_KEYFRAME = (0, 0, 255)
_COVIS = (0, 128, 0)
_TREE = (0, 102, 0)
_LOOP = (191, 0, 191)
_TRAJECTORY = (255, 0, 0)
_CAMERA = (0, 255, 0)  # the reference's DrawCurrentCamera green
#: the map view's size in pixels (the JAX package's 8 x 8 in figure at 100 dpi)
MAP_SIZE = 800


class FrameDrawer:
    """Annotated current-frame rendering (reference src/FrameDrawer.cpp)."""

    def __init__(self, system):
        self.system = system
        self.image: Optional[np.ndarray] = None
        self.frame = None  # the snapshot: dict of host arrays, or None
        self.state = None
        self.n_tracked = 0
        self.n_tracked_vo = 0

    def update(self, image=None):
        """Snapshot the tracker's last frame and `image` (numpy or a tensor,
        copied to the host here)."""
        tr = self.system.tracker
        lf = tr.last_frame
        self.state = tr.state
        if image is not None:
            self.image = image.cpu().numpy() if isinstance(image, torch.Tensor) else np.asarray(image)
        if lf is None:
            self.frame = None
            return
        temp = set(getattr(lf, "temp_points", {}) or {})
        self.frame = dict(uv=lf.uv.copy(), valid=lf.valid.copy(), point_ids=lf.point_ids.copy(),
                          outlier=lf.outlier.copy(), temp=temp)
        ok = self.frame["valid"] & (self.frame["point_ids"] >= 0) & ~self.frame["outlier"]
        self.n_tracked = int(ok.sum())
        self.n_tracked_vo = len(temp)

    def status_text(self) -> str:
        """State line (FrameDrawer::DrawTextInfo, FrameDrawer.cpp)."""
        from .tracking import TrackingState

        m = self.system.map
        if self.state is None or self.state == TrackingState.NO_IMAGES_YET:
            return "WAITING FOR IMAGES"
        if self.state == TrackingState.NOT_INITIALIZED:
            return "TRYING TO INITIALIZE"
        if self.state == TrackingState.LOST:
            return "TRACK LOST. TRYING TO RELOCALIZE"
        mode = "LOCALIZATION" if getattr(self.system.tracker, "only_tracking", False) else "SLAM MODE"
        txt = f"{mode} | KFs: {m.n_keyframes()}, MPs: {len(m.pt_valid)}, Matches: {self.n_tracked}"
        if self.n_tracked_vo:
            txt += f", + VO matches: {self.n_tracked_vo}"
        return txt

    def draw_frame(self) -> Optional[np.ndarray]:
        """RGB uint8 image with tracked features marked (DrawFrame)."""
        lf = self.frame
        if lf is None:
            return None
        H = self.system.config.camera.height
        W = self.system.config.camera.width
        if self.image is not None and self.image.shape[:2] == (H, W):
            base = np.clip(self.image, 0, 255).astype(np.uint8)
            img = np.repeat(base[:, :, None], 3, axis=2)
        else:
            img = np.full((H, W, 3), 40, np.uint8)
        idx = np.nonzero(lf["valid"])[0]
        u = lf["uv"][idx, 0].astype(int)
        v = lf["uv"][idx, 1].astype(int)
        inside = (u >= 0) & (u < W) & (v >= 0) & (v < H)
        idx, u, v = idx[inside], u[inside], v[inside]
        tracked = (lf["point_ids"][idx] >= 0) & ~lf["outlier"][idx]
        vo = np.isin(idx, np.fromiter(lf["temp"], np.int64, len(lf["temp"])))
        colors = np.where(tracked[:, None], _GREEN, np.where(vo[:, None], _BLUE, _GRAY)).astype(np.uint8)
        # 3 x 3 boxes, clipped at the border; where boxes overlap, the later
        # feature's wins, as the JAX package paints them in index order
        owner = np.full(H * W, -1)
        for dv in (-1, 0, 1):
            for du in (-1, 0, 1):
                uu, vv = u + du, v + dv
                ok = (uu >= 0) & (uu < W) & (vv >= 0) & (vv < H)
                np.maximum.at(owner, vv[ok] * W + uu[ok], np.nonzero(ok)[0])
        painted = owner >= 0
        img.reshape(-1, 3)[painted] = colors[owner[painted]]
        img[-18:, :] = 0  # the status bar, blank without a font renderer
        return img


def _clip(p0: np.ndarray, p1: np.ndarray, w: int, h: int):
    """Liang-Barsky: the segments p0 -> p1 ([n, 2] pixel coordinates) cut to
    [0, w-1] x [0, h-1]; returns (start, end, kept)."""
    d = p1 - p0
    t0, t1 = np.zeros(len(d)), np.ones(len(d))
    with np.errstate(divide="ignore", invalid="ignore"):
        for k, hi in ((0, w - 1), (1, h - 1)):
            for p, q in ((-d[:, k], p0[:, k]), (d[:, k], hi - p0[:, k])):
                r = q / p
                t0 = np.where(p < 0, np.maximum(t0, r), t0)
                t1 = np.where(p > 0, np.minimum(t1, r), t1)
                t1 = np.where((p == 0) & (q < 0), -1.0, t1)
    return p0 + t0[:, None] * d, p0 + t1[:, None] * d, t0 <= t1


class _Canvas:
    """A square raster over the world's x-z plane (z up)."""

    def __init__(self, size: int, centre, half: float):
        self.img = np.full((size, size, 3), _WHITE, np.uint8)
        self.size = size
        self.centre = np.asarray(centre, np.float64)
        self.scale = (size - 1) / (2.0 * half)

    def px(self, xz: np.ndarray) -> np.ndarray:
        """World (x, z) [n, 2] -> pixel (column, row) [n, 2] float."""
        c = (xz[:, 0] - self.centre[0]) * self.scale + (self.size - 1) / 2
        r = (self.centre[1] - xz[:, 1]) * self.scale + (self.size - 1) / 2
        return np.stack([c, r], 1)

    def dots(self, xz: np.ndarray, color, radius: int = 0):
        if not len(xz):
            return
        p = np.rint(self.px(xz)).astype(np.int64)
        for dr in range(-radius, radius + 1):
            for dc in range(-radius, radius + 1):
                c, r = p[:, 0] + dc, p[:, 1] + dr
                ok = (c >= 0) & (c < self.size) & (r >= 0) & (r < self.size)
                self.img[r[ok], c[ok]] = color

    def lines(self, a: np.ndarray, b: np.ndarray, color):
        """Segments a -> b ([n, 2] world x-z), by a DDA over the clipped
        segments: max(|dc|, |dr|) + 1 samples each, rounded."""
        if not len(a):
            return
        p0, p1, kept = _clip(self.px(a), self.px(b), self.size, self.size)
        p0, p1 = p0[kept], p1[kept]
        d = p1 - p0
        steps = np.ceil(np.abs(d).max(axis=1)).astype(np.int64) + 1
        seg = np.repeat(np.arange(len(d)), steps)
        k = np.arange(steps.sum()) - np.repeat(np.cumsum(steps) - steps, steps)
        t = k / np.maximum(steps[seg] - 1, 1)
        p = np.rint(p0[seg] + d[seg] * t[:, None]).astype(np.int64)
        p = np.clip(p, 0, self.size - 1)
        self.img[p[:, 1], p[:, 0]] = color

    def triangle(self, xz: np.ndarray, color, radius: int = 6):
        """A filled upward triangle marker centred on xz [2]."""
        c0, r0 = np.rint(self.px(xz[None])[0]).astype(np.int64)
        dr, dc = np.mgrid[-radius:radius + 1, -radius:radius + 1]
        inside = np.abs(dc) * 2 <= dr + radius
        r, c = (r0 + dr)[inside], (c0 + dc)[inside]
        ok = (c >= 0) & (c < self.size) & (r >= 0) & (r < self.size)
        self.img[r[ok], c[ok]] = color


class MapDrawer:
    """Map rendering (reference src/MapDrawer.cpp) into a numpy raster:
    points, keyframes, covisibility graph / spanning tree / loop edges,
    trajectory, current camera. ``save`` writes the view as a PNG."""

    def __init__(self, system, covis_min_weight: int = 100):
        self.system = system
        self.covis_min_weight = covis_min_weight
        self._Tcw: Optional[np.ndarray] = None

    def set_current_camera_pose(self, Tcw: np.ndarray):
        """SetCurrentCameraPose (MapDrawer.cpp)."""
        self._Tcw = None if Tcw is None else np.array(Tcw)

    def snapshot(self) -> dict:
        """Copies of what the view draws, from the map's and the tracker's
        host arrays (the caller holds the map lock where other threads
        write the map)."""
        m = self.system.map
        pts = m.pt_ids()
        ref = np.asarray(m.reference_points, np.int64).reshape(-1)
        ref = ref[m.valid_mask(ref)]
        kfs = sorted(m.kf_valid)
        centres = {k: m.kf_center(k) for k in kfs}
        heads = {k: m.kf_pose[k][:3, :3].T.astype(np.float64) @ np.array([0.0, 0.0, 1.0]) for k in kfs}
        covis, tree, loops = [], [], []
        for k in kfs:
            covis += [(k, nb) for nb, w in m.covis.get(k, {}).items()
                      if nb > k and nb in centres and w >= self.covis_min_weight]
            parent = m.parent.get(k)
            if parent is not None and parent in centres:
                tree.append((k, parent))
            loops += [(k, le) for le in m.loop_edges.get(k, ()) if le > k and le in centres]
        traj = [e.Tcw for e in self.system.tracker.trajectory if e.Tcw is not None]
        return dict(points=m.pt_pos[pts].copy(), reference=m.pt_pos[ref].copy(), centres=centres, heads=heads,
                    covis=covis, tree=tree, loops=loops,
                    trajectory=np.array([-T[:3, :3].T @ T[:3, 3] for T in traj]).reshape(-1, 3),
                    camera=None if self._Tcw is None else -self._Tcw[:3, :3].T @ self._Tcw[:3, 3])

    @staticmethod
    def _view(snap, show_points, follow, follow_radius):
        """(centre, half-width) of the square view."""
        if follow and snap["camera"] is not None:
            return snap["camera"][[0, 2]], follow_radius
        parts = [snap["trajectory"], np.array(list(snap["centres"].values())).reshape(-1, 3)]
        if show_points:
            parts.append(snap["points"])
        if snap["camera"] is not None:
            parts.append(snap["camera"][None])
        xz = np.concatenate(parts)[:, [0, 2]]
        if not len(xz):
            return np.zeros(2), 1.0
        lo, hi = xz.min(axis=0), xz.max(axis=0)
        return (lo + hi) / 2, max(float((hi - lo).max()) / 2 * 1.05, 0.5)

    def render(self, snap: dict, show_points=True, show_keyframes=True, show_graph=True, follow=False,
               follow_radius=8.0) -> np.ndarray:
        """The map view of a `snapshot()` as RGB uint8 [MAP_SIZE, MAP_SIZE, 3]."""
        canvas = _Canvas(MAP_SIZE, *self._view(snap, show_points, follow, follow_radius))
        xz = lambda a: np.asarray(a, np.float64).reshape(-1, 3)[:, [0, 2]]  # noqa: E731
        if show_points:
            canvas.dots(xz(snap["points"]), _POINT)
            canvas.dots(xz(snap["reference"]), _REFERENCE)
        centres = snap["centres"]
        if show_keyframes and centres:
            if show_graph:
                for edges, color in ((snap["covis"], _COVIS), (snap["tree"], _TREE), (snap["loops"], _LOOP)):
                    if edges:
                        canvas.lines(xz([centres[a] for a, _ in edges]), xz([centres[b] for _, b in edges]), color)
            ks = sorted(centres)
            c = xz([centres[k] for k in ks])
            canvas.lines(c, c + 0.15 * xz([snap["heads"][k] for k in ks]), _KEYFRAME)
            canvas.dots(c, _KEYFRAME, radius=1)
        traj = xz(snap["trajectory"])
        if len(traj) > 1:
            canvas.lines(traj[:-1], traj[1:], _TRAJECTORY)
        if snap["camera"] is not None:
            canvas.triangle(snap["camera"][[0, 2]], _CAMERA)
        return canvas.img

    def render_array(self, **kw) -> np.ndarray:
        """Render the map view to an RGB array (the live viewer's frame
        buffer, the headless analog of the Pangolin framebuffer)."""
        return self.render(self.snapshot(), **kw)

    def save(self, path: str, show_points=True, show_keyframes=True, show_graph=True):
        png.write(path, self.render_array(show_points=show_points, show_keyframes=show_keyframes,
                                          show_graph=show_graph))


class Viewer:
    """Headless viewer loop (reference src/Viewer.cpp): drives both drawers
    once per frame and writes throttled map snapshots. The Pangolin menu
    toggles (Viewer.cpp:46-52) are plain attributes."""

    def __init__(self, system, every_n: int = 30, out_dir: Optional[str] = None):
        self.system = system
        self.every_n = every_n
        self.out_dir = out_dir
        self.frame_drawer = FrameDrawer(system)
        self.map_drawer = MapDrawer(system)
        # menu toggles (menuFollowCamera / menuShowPoints / ...), read by
        # every render; the setters may be called from any thread while the
        # live loop runs, as Pangolin menu clicks are
        self.follow_camera = False
        self.show_points = True
        self.show_keyframes = True
        self.show_graph = True
        self._count = 0
        self._menu_lock = threading.Lock()
        self._pending_cmds = []
        self._live_thread = None
        self.latest_frame: Optional[np.ndarray] = None
        self.latest_map: Optional[np.ndarray] = None
        self.n_live_renders = 0
        self.live_error: Optional[BaseException] = None

    # ---- runtime menu controls (reference Viewer.cpp:46-52,60-113) ----

    def set_follow_camera(self, on: bool):
        """menuFollowCamera: lock the map viewport onto the camera."""
        self.follow_camera = bool(on)

    def set_show(self, points=None, keyframes=None, graph=None):
        """menuShowPoints / menuShowKeyFrames / menuShowGraph."""
        if points is not None:
            self.show_points = bool(points)
        if keyframes is not None:
            self.show_keyframes = bool(keyframes)
        if graph is not None:
            self.show_graph = bool(graph)

    def set_localization_mode(self, on: bool):
        """menuLocalizationMode (Viewer.cpp:87-97): queued and applied by the
        viewer loop, as the reference calls Activate/
        DeactivateLocalizationMode from its render thread."""
        with self._menu_lock:
            self._pending_cmds.append(("localization", bool(on)))

    def request_reset(self):
        """menuReset (Viewer.cpp:99-108): full system reset from the UI."""
        with self._menu_lock:
            self._pending_cmds.append(("reset",))

    def poll_menu(self):
        """Apply queued menu commands (called by the live loop each
        iteration; callable directly in unthreaded use)."""
        with self._menu_lock:
            cmds, self._pending_cmds = self._pending_cmds, []
        for cmd in cmds:
            if cmd[0] == "localization":
                if cmd[1]:
                    self.system.activate_localization_mode()
                else:
                    self.system.deactivate_localization_mode()
            elif cmd[0] == "reset":
                self.system.reset()

    def update(self, image=None):
        """Called after each tracked frame, on the tracking thread."""
        self._count += 1
        self.frame_drawer.update(image)
        lf = self.system.tracker.last_frame
        if lf is not None and lf.Tcw is not None:
            self.map_drawer.set_current_camera_pose(lf.Tcw)
        if self.out_dir is not None and self._count % self.every_n == 0:
            self.save(os.path.join(self.out_dir, f"map_{self._count:06d}.png"))

    def draw_frame(self) -> Optional[np.ndarray]:
        if self.frame_drawer.frame is None:
            self.frame_drawer.update()
        return self.frame_drawer.draw_frame()

    def render_array(self) -> np.ndarray:
        """The map view with the current menu toggles: the map's host arrays
        copied under the map lock, rendered outside it."""
        with self.system.map.lock:
            snap = self.map_drawer.snapshot()
        return self.map_drawer.render(snap, show_points=self.show_points, show_keyframes=self.show_keyframes,
                                      show_graph=self.show_graph, follow=self.follow_camera)

    def save(self, path: str):
        png.write(path, self.render_array())

    # ---- live thread (reference Viewer::Run, Viewer.cpp:32-113) ------

    def run_live(self, fps: float = 5.0):
        """Start the live rendering thread: at ~fps it applies the queued
        menu commands, then renders both views into `latest_frame` and
        `latest_map` (and, with `out_dir`, live_frame.png / live_map.png,
        each by an atomic rename). Idempotent; `stop_live()` joins it."""
        if self._live_thread is not None:
            return
        self.live_error = None
        self._live_stop = threading.Event()
        period = 1.0 / max(fps, 1e-3)

        def loop():
            while not self._live_stop.is_set():
                t0 = time.monotonic()
                try:
                    # menu commands first, outside the map lock (the
                    # reference polls its menus each iteration and calls
                    # into System, Viewer.cpp:60-113)
                    self.poll_menu()
                    frame_img = self.frame_drawer.draw_frame()
                    map_img = self.render_array()
                    self.latest_frame, self.latest_map = frame_img, map_img
                    self.n_live_renders += 1
                    if self.out_dir is not None:
                        self._write_live(frame_img, map_img)
                except Exception as e:  # ends the thread; stop_live raises it
                    self.live_error = e
                    return
                self._live_stop.wait(max(period - (time.monotonic() - t0), 0.01))

        self._live_thread = threading.Thread(target=loop, name="viewer", daemon=True)
        self._live_thread.start()

    def _write_live(self, frame_img, map_img):
        os.makedirs(self.out_dir, exist_ok=True)
        for name, img in (("live_frame", frame_img), ("live_map", map_img)):
            if img is None:
                continue
            tmp = os.path.join(self.out_dir, f".{name}.tmp.png")
            png.write(tmp, img.astype(np.uint8))
            os.replace(tmp, os.path.join(self.out_dir, f"{name}.png"))

    def stop_live(self):
        """Stop and join the live thread; raises the error that ended it."""
        th = self._live_thread
        if th is None:
            return
        self._live_stop.set()
        th.join(timeout=30.0)
        self._live_thread = None
        if self.live_error is not None:
            raise RuntimeError("the viewer's live thread failed") from self.live_error
