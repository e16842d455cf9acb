"""System facade: the public API of the SLAM engine (stereo and
monocular tracking, local mapping, relocalization and localization mode,
loop closing).

Port of orbslam2_tpu/slam/system.py (reference include/System.hpp:55-117,
src/System.cpp): construction wires the stages (vocabulary and keyframe
database, tracking, local mapping, loop closing), `track_stereo` and
`track_monocular` are the per-frame entries (the sensor chosen at
construction), plus localization-mode switching, reset, wait_idle,
shutdown with the stage-timing report, the four trajectory savers, and
`precompile`, which warms the rare-event device programs before a run.

The local mapper processes each keyframe inline in the tracking call, one
queued keyframe per frame with `deferred_mapping=True`, or on a worker
thread with `threaded=True` (reference System.cpp:63-65). With a
vocabulary, a `Relocalizer` indexes every keyframe the mapper finishes
and brings a lost tracker back; without one a lost tracker stays lost.
With a vocabulary and `enable_loop_closing=True` (the default), a
`LoopCloser` takes each keyframe the mapper finishes, indexes it, looks
for a loop, corrects it and runs the global BA: synchronously on the
thread that mapped the keyframe, or, with `threaded=True`, on a
`LoopWorker` thread, with each global BA on a thread of its own (reference
System.cpp:66-70, LoopClosing.cpp:566-570). A monocular System closes
loops with a free scale (Sim3, `fix_scale=False`). With `use_viewer=True`
a headless `Viewer` renders both views on a thread of its own (reference
System.cpp:72-77). `save_map` / `load_map` checkpoint the map in the JAX
package's npz format. With `mesh` (`parallel/mesh.py`) the loop closer
shards its whole-map passes, the essential graph and the global BA, over
the mesh's devices; tracking and mapping stay on `device`.

    system = System("assets/vocab_generic.npz", cfg)
    system = System("assets/vocab_generic.npz", cfg, sensor=Sensor.MONOCULAR)
    system = System("assets/vocab_generic.npz", cfg, mesh=make_mesh(2))
"""

from __future__ import annotations

import threading

import torch

from ..config import SlamConfig, load_config
from ..vocab import bow as bow_mod
from . import checkpoint, precompile as precompile_mod
from . import trajectory as traj_mod
from .frontend import Frontend
from .local_mapping import LocalMapper
from .loop_closing import LoopCloser
from .map import SlamMap
from .pipeline import LoopWorker, MappingWorker
from .timing import StageTimers
from .relocalization import Relocalizer
from .tracking import Tracker, TrackingState
from .viewer import Viewer


class Sensor:
    STEREO = "stereo"
    MONOCULAR = "monocular"


class System:
    """The port's analog of the reference's ORB_SLAM_CUSTOM::System."""

    def __init__(
        self,
        vocabulary,  # path to a .npz / DBoW2 text vocabulary, a Vocabulary, or None
        settings,  # path to an (OpenCV-style) YAML, or a SlamConfig
        sensor: str = Sensor.STEREO,
        use_viewer: bool = False,
        enable_loop_closing: bool = True,
        deferred_mapping: bool = False,
        threaded: bool = False,
        mesh=None,  # parallel.mesh.Mesh: shard the whole-map passes (global BA, essential graph)
        *,
        device="cuda",
    ):
        if sensor not in (Sensor.STEREO, Sensor.MONOCULAR):
            raise ValueError(f"unknown sensor {sensor!r}")
        self.sensor = sensor
        self.device = torch.device(device)
        if self.device.type == "cuda":
            # the JAX package pins precision="highest": no TF32 anywhere
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.config = settings if isinstance(settings, SlamConfig) else load_config(settings)
        self.config.sensor = sensor

        self.frontend = Frontend(self.config, self.device)
        self.map = SlamMap(
            self.config.orb.n_features, self.config.orb.n_levels, self.config.orb.scale_factor
        )
        self.tracker = Tracker(self.config, self.frontend, self.map)
        self.local_mapper = LocalMapper(self.config, self.frontend, self.map, deferred=deferred_mapping)
        self.tracker.local_mapper = self.local_mapper

        self.vocabulary = self._load_vocabulary(vocabulary)
        self.relocalizer = None
        self.loop_closer = None
        if self.vocabulary is not None:
            reloc = Relocalizer(self.config, self.frontend, self.map, self.vocabulary)
            self.relocalizer = reloc
            self.tracker.relocalizer = reloc
            self.map.on_keyframe_removed = reloc.remove_keyframe
            if enable_loop_closing:
                self.loop_closer = LoopCloser(self.config, self.frontend, self.map, reloc,
                                              local_mapper=self.local_mapper,
                                              fix_scale=(sensor != Sensor.MONOCULAR), mesh=mesh)
                self.local_mapper.on_processed = self.loop_closer.insert_keyframe
                self.loop_closer.on_pose_jump = self.tracker.apply_pose_jump
            else:
                # under the map lock: with threaded=True this runs on the
                # mapping worker beside the tracker
                self.local_mapper.on_processed = lambda kf: reloc.add_keyframe(kf, lock=self.map.lock)
        # the tracker's early-loss reset is the full reset
        self.tracker.on_reset = self.reset
        self.timers = StageTimers()
        self.tracker.timers = self.timers
        self.local_mapper.timers = self.timers
        if self.loop_closer is not None:
            self.loop_closer.timers = self.timers
        # threaded: the mapper and the loop closer each drain their queue on
        # a worker thread, and the global BA runs on a thread of its own
        # (reference System.cpp:63-70); the tracker only ever waits on the
        # map lock, never on a BA solve or a Sim3 search
        self.worker = MappingWorker(self.local_mapper) if threaded else None
        self.loop_worker = None
        if threaded and self.loop_closer is not None:
            self.loop_worker = LoopWorker(self.loop_closer)
            self.local_mapper.on_processed = self.loop_worker.submit
            self.loop_closer.threaded_gba = True
        # held by each tracking call, and by a reset or a localization-mode
        # switch from another thread (the viewer's menu), which thus waits
        # for the frame in flight, as the reference applies them at the start
        # of the next frame (its TrackStereo's mode and reset checks,
        # System.cpp:90-142); reentrant: the tracker's early-loss reset comes
        # from inside a tracking call
        self._track_lock = threading.RLock()
        self.viewer = None
        if use_viewer:
            # the headless live loop renders both views at ~5 fps into
            # in-memory buffers (+ PNG files when out_dir is set)
            self.viewer = Viewer(self)
            self.viewer.run_live()

    def _load_vocabulary(self, vocabulary):
        if vocabulary is None:
            return None
        if isinstance(vocabulary, bow_mod.Vocabulary):
            return bow_mod.to_device(vocabulary, self.device)
        if str(vocabulary).endswith(".npz"):
            return bow_mod.load_npz(vocabulary, self.device)
        return bow_mod.load_dbow2_text(vocabulary, self.device)

    # ------------------------------------------------------------------

    def track_stereo(self, im_left, im_right, timestamp: float):
        """Per-frame entry (reference System::TrackStereo, System.cpp:90-142).
        Returns Tcw [4,4], or None when tracking is lost.

        Return contract by mode (JAX slam/system.py:132-147): synchronous
        (the default), the frame's SOLVED pose, as the reference's
        TrackStereo returns it; with `config.pipelined_tracking`, while the
        pipeline is engaged, the motion-model PREDICTION for the new frame
        (its fused step is still in flight): the solved pose is recorded in
        the trajectory when the next frame applies it, one frame later."""
        with self._track_lock:
            with self.timers.span("Total tracking"):
                Tcw = self.tracker.track(im_left, im_right, timestamp)
            if self.viewer is not None:
                self.viewer.update(image=im_left)
        return Tcw

    def track_monocular(self, image, timestamp: float):
        """Monocular per-frame entry (upstream System::TrackMonocular): the
        first frames go to the two-view initializer. Returns the frame's
        solved Tcw [4,4] (up to the map's scale), or None when tracking is
        lost or not initialized yet."""
        with self._track_lock:
            with self.timers.span("Total tracking"):
                Tcw = self.tracker.track_mono(image, timestamp)
            if self.viewer is not None:
                self.viewer.update(image=image)
        return Tcw

    def activate_localization_mode(self):
        """Reference ActivateLocalizationMode: mapping paused, tracking only."""
        with self._track_lock:
            self.tracker.flush_pipeline()
            self.tracker.only_tracking = True
            self.local_mapper.request_stop()

    def deactivate_localization_mode(self):
        with self._track_lock:
            self.tracker.only_tracking = False
            self.local_mapper.release()

    def reset(self):
        """Full reset (reference Tracking::Reset, Tracking.cpp:1348-1388):
        the map, the tracker, the mapper's queue and recent points, the
        keyframe database, the loop worker's queue and the loop state (a
        running global BA is stopped and joined). The tracker's early-loss
        reset comes here too. From another thread it waits for the frame
        being tracked."""
        with self._track_lock:
            if self.loop_worker is not None:
                with self.loop_worker._cv:
                    self.loop_worker._queue.clear()
            if self.loop_closer is not None:
                self.loop_closer.reset()
            self.tracker.reset()
            self.local_mapper.recent_points = []
            self.local_mapper._queue.clear()
            if self.relocalizer is not None:
                self.relocalizer.database.clear()

    def wait_idle(self, timeout: float = 120.0):
        """Block until the queued mapping and loop-closing work is done: the
        mapping worker, then the loop worker and its global BA, then the
        mapping worker again (a correction releases the mapper). The
        pipelined tracker's dispatched frames are applied first. Raises a
        worker's error, if it had one."""
        with self._track_lock:
            self.tracker.flush_pipeline()
        if self.worker is not None:
            self.worker.wait_idle(timeout)
        if self.loop_worker is not None:
            self.loop_worker.wait_idle(timeout)
            self.loop_closer.wait_gba(timeout)
            if self.worker is not None:
                self.worker.wait_idle(timeout)

    def shutdown(self, measure_frontend_split: bool = False) -> str:
        """Drain and stop the mapping and loop workers, wait for a global BA
        on its own thread (reference Shutdown barrier, System.cpp:227-242),
        stop the viewer (raising its thread's error, if it had one), and
        return the stage-timing report (System.cpp:244).

        With measure_frontend_split=True the frame's "ORB extraction +
        stereo matching" is also reported as the reference's two stages
        (Frame.cpp:112-132): `Frontend.measure_stage_split` times the
        extraction alone against the whole front end on the last stereo
        pair, and the difference goes to "Stereo matching".

        The pipelined tracker's dispatched frames are applied first."""
        with self._track_lock:
            self.tracker.flush_pipeline()
        if self.worker is not None:
            self.worker.finish()
            self.worker = None
        if self.loop_worker is not None:
            self.loop_worker.finish()
            self.loop_worker = None
        if self.loop_closer is not None:
            self.loop_closer.wait_gba()
        if self.viewer is not None:
            self.viewer.stop_live()
        if measure_frontend_split and self.tracker.last_images is not None:
            t_orb, t_full = self.frontend.measure_stage_split(*self.tracker.last_images)
            for a, b in zip(t_orb, t_full):
                self.timers.add("ORB extraction", a * 1e6)
                self.timers.add("Stereo matching", max(b - a, 0.0) * 1e6)
        return self.timers.report()

    def precompile(self) -> float:
        """Warm every device program that a rare event runs (relocalization,
        loop closing, the mapper's BA, the kernels' first launches), on this
        System's device at its configured sizes, from dummy inputs, so that
        no first-use cost lands mid-run (JAX slam/system.py:213-474; see
        `slam/precompile.py`). Raises on any failure. Leaves the map, the
        keyframe database, the trajectory, the tracker, the launch counters
        and the stage timers as they were; call it while the System is
        idle, e.g. before the first frame. Returns its seconds."""
        with self._track_lock:
            return precompile_mod.warm(self)

    # ------------------------------------------------------------------

    def get_tracking_state(self) -> TrackingState:
        return self.tracker.state

    def get_tracked_map_points(self):
        lf = self.tracker.last_frame
        if lf is None:
            return []
        return [int(p) for p in lf.point_ids[lf.point_ids >= 0]]

    def map_changed(self) -> int:
        return self.map.big_change_idx

    # ------------------------------------------------------------------

    def save_trajectory_tum(self, path: str):
        traj_mod.save_lines(path, traj_mod.trajectory_tum(self.tracker.trajectory, self.map))

    def save_offline_trajectory_tum(self, path: str):
        traj_mod.save_lines(
            path, traj_mod.trajectory_tum(self.tracker.trajectory, self.map, offline=True)
        )

    def save_keyframe_trajectory_tum(self, path: str):
        traj_mod.save_lines(path, traj_mod.keyframe_trajectory_tum(self.map))

    def save_trajectory_kitti(self, path: str):
        traj_mod.save_lines(path, traj_mod.trajectory_kitti(self.tracker.trajectory, self.map))

    # ------------------------------------------------------------------

    def save_map(self, path: str):
        """Map checkpointing, absent in the reference (a TODO at
        System.hpp:109-111): the JAX package's npz format."""
        checkpoint.save_map(self.map, path)

    def load_map(self, path: str):
        """Replace the map by the one saved at `path` (by either package);
        its keyframes' features go to this System's device. The keyframe
        database is emptied and every loaded keyframe indexed in it (one K4
        launch each), under the map lock, so that relocalization and loop
        detection reach the loaded keyframes (the reference has no LoadMap,
        System.hpp:109-111; its database holds every keyframe). The JAX
        package leaves the database empty."""
        checkpoint.load_map(self.map, path, self.device)
        if self.relocalizer is not None:
            with self.map.lock:
                self.relocalizer.database.clear()
                for kf in sorted(self.map.kf_valid):
                    self.relocalizer.add_keyframe(kf)
