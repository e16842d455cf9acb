"""System facade: the public API of the SLAM engine (stereo tracking,
local mapping, relocalization and localization mode).

Port of orbslam2_tpu/slam/system.py (reference include/System.hpp:55-117,
src/System.cpp): construction wires the stages (vocabulary and keyframe
database, tracking, local mapping), `track_stereo` is the per-frame
entry, plus localization-mode switching, reset, wait_idle, shutdown with
the stage-timing report, and the four trajectory savers.

The local mapper processes each keyframe inline in `track_stereo`, one
queued keyframe per frame with `deferred_mapping=True`, or on a worker
thread with `threaded=True` (reference System.cpp:63-65). With a
vocabulary, a `Relocalizer` indexes every keyframe the mapper finishes
(on the worker thread when threaded) and brings a lost tracker back;
without one a lost tracker stays lost. Loop closing is not ported: a
vocabulary with `enable_loop_closing=True` raises, as do the other
unported parts (a viewer, a device mesh, the monocular sensor), each
naming its ROADMAP item.

    system = System("assets/vocab_generic.npz", cfg, enable_loop_closing=False)
"""

from __future__ import annotations

import torch

from ..config import SlamConfig, load_config
from ..vocab import bow as bow_mod
from . import trajectory as traj_mod
from .frontend import Frontend
from .local_mapping import LocalMapper
from .map import SlamMap
from .pipeline import MappingWorker
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
        if vocabulary is not None and enable_loop_closing:
            raise _not_ported("loop closing", "loop closing")
        if sensor == Sensor.MONOCULAR:
            raise _not_ported("the monocular sensor", "monocular/MLPnP/undistort")
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
        self.config.sensor = "stereo"

        self.frontend = Frontend(self.config, self.device)
        self.map = SlamMap(
            self.config.orb.n_features, self.config.orb.n_levels, self.config.orb.scale_factor
        )
        self.tracker = Tracker(self.config, self.frontend, self.map)
        self.local_mapper = LocalMapper(self.config, self.frontend, self.map, deferred=deferred_mapping)
        self.tracker.local_mapper = self.local_mapper

        self.vocabulary = self._load_vocabulary(vocabulary)
        self.relocalizer = None
        if self.vocabulary is not None:
            reloc = Relocalizer(self.config, self.frontend, self.map, self.vocabulary)
            self.relocalizer = reloc
            self.tracker.relocalizer = reloc
            self.map.on_keyframe_removed = reloc.remove_keyframe
            # under the map lock: with threaded=True this runs on the
            # mapping worker beside the tracker
            self.local_mapper.on_processed = lambda kf: reloc.add_keyframe(kf, lock=self.map.lock)
        self.timers = StageTimers()
        self.tracker.timers = self.timers
        self.local_mapper.timers = self.timers
        # threaded: the mapper drains its queue on a worker thread, and the
        # tracker only ever waits on the map lock, never on a BA solve
        self.worker = MappingWorker(self.local_mapper) if threaded else None

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
        keyframe database."""
        self.tracker.reset()
        self.local_mapper.recent_points = []
        self.local_mapper._queue.clear()
        if self.relocalizer is not None:
            self.relocalizer.database.clear()

    def wait_idle(self, timeout: float = 120.0):
        """Block until the mapping worker has drained its queue (no-op
        unless threaded); raises the worker's error, if it had one."""
        if self.worker is not None:
            self.worker.wait_idle(timeout)

    def shutdown(self) -> str:
        """Drain and stop the mapping worker (reference Shutdown barrier,
        System.cpp:227-242) and return the stage-timing report
        (System.cpp:244)."""
        if self.worker is not None:
            self.worker.finish()
            self.worker = None
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
