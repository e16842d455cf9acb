"""System facade: the public API of the SLAM engine (stereo and
monocular tracking, local mapping, relocalization and localization mode,
loop closing).

Port of orbslam2_tpu/slam/system.py (reference include/System.hpp:55-117,
src/System.cpp): construction wires the stages (vocabulary and keyframe
database, tracking, local mapping, loop closing), `track_stereo` and
`track_monocular` are the per-frame entries (the sensor chosen at
construction), plus localization-mode switching, reset, wait_idle,
shutdown with the stage-timing report, and the four trajectory savers.

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
loops with a free scale (Sim3, `fix_scale=False`). A viewer and a device
mesh are not ported yet and raise, naming their ROADMAP item.

    system = System("assets/vocab_generic.npz", cfg)
    system = System("assets/vocab_generic.npz", cfg, sensor=Sensor.MONOCULAR)
"""

from __future__ import annotations

import torch

from ..config import SlamConfig, load_config
from ..vocab import bow as bow_mod
from . import trajectory as traj_mod
from .frontend import Frontend
from .local_mapping import LocalMapper
from .loop_closing import LoopCloser
from .map import SlamMap
from .pipeline import LoopWorker, MappingWorker
from .timing import StageTimers
from .relocalization import Relocalizer
from .tracking import Tracker, TrackingState


class Sensor:
    STEREO = "stereo"
    MONOCULAR = "monocular"


def _not_ported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP queue 1: {item})")


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
        mesh=None,
        *,
        device="cuda",
    ):
        if sensor not in (Sensor.STEREO, Sensor.MONOCULAR):
            raise ValueError(f"unknown sensor {sensor!r}")
        if use_viewer:
            raise _not_ported("the viewer", "checkpoint/viewer/drivers")
        if mesh is not None:
            raise _not_ported("multi-device execution", "multi-GPU")
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
                                              fix_scale=(sensor != Sensor.MONOCULAR))
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
        Returns the frame's solved Tcw [4,4], or None when tracking is lost."""
        with self.timers.span("Total tracking"):
            return self.tracker.track(im_left, im_right, timestamp)

    def track_monocular(self, image, timestamp: float):
        """Monocular per-frame entry (upstream System::TrackMonocular): the
        first frames go to the two-view initializer. Returns the frame's
        solved Tcw [4,4] (up to the map's scale), or None when tracking is
        lost or not initialized yet."""
        with self.timers.span("Total tracking"):
            return self.tracker.track_mono(image, timestamp)

    def activate_localization_mode(self):
        """Reference ActivateLocalizationMode: mapping paused, tracking only."""
        self.tracker.only_tracking = True
        self.local_mapper.request_stop()

    def deactivate_localization_mode(self):
        self.tracker.only_tracking = False
        self.local_mapper.release()

    def reset(self):
        """Full reset (reference Tracking::Reset, Tracking.cpp:1348-1388):
        the map, the tracker, the mapper's queue and recent points, the
        keyframe database, the loop worker's queue and the loop state (a
        running global BA is stopped and joined). The tracker's early-loss
        reset comes here too."""
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
        mapping worker again (a correction releases the mapper). A no-op
        unless threaded; raises a worker's error, if it had one."""
        if self.worker is not None:
            self.worker.wait_idle(timeout)
        if self.loop_worker is not None:
            self.loop_worker.wait_idle(timeout)
            self.loop_closer.wait_gba(timeout)
            if self.worker is not None:
                self.worker.wait_idle(timeout)

    def shutdown(self) -> str:
        """Drain and stop the mapping and loop workers, wait for a global BA
        on its own thread (reference Shutdown barrier, System.cpp:227-242),
        and return the stage-timing report (System.cpp:244)."""
        if self.worker is not None:
            self.worker.finish()
            self.worker = None
        if self.loop_worker is not None:
            self.loop_worker.finish()
            self.loop_worker = None
        if self.loop_closer is not None:
            self.loop_closer.wait_gba()
        return self.timers.report()

    # ------------------------------------------------------------------

    def get_tracking_state(self) -> TrackingState:
        return self.tracker.state

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
