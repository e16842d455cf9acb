"""System facade: the public API of the SLAM engine (stereo tracking).

Port of orbslam2_tpu/slam/system.py (reference include/System.hpp:55-117,
src/System.cpp): construction wires the stages, `track_stereo` is the
per-frame entry, plus reset, shutdown with the stage-timing report, and
the four trajectory savers.

Ported so far: stereo tracking. Local mapping and loop closing are not:
`local_mapper` is None, and the arguments that would need them (a
vocabulary, `threaded=True`, deferred mapping, a viewer, a device mesh,
the monocular sensor) raise NotImplementedError naming the ROADMAP item.
"""

from __future__ import annotations

import torch

from ..config import SlamConfig, load_config
from . import trajectory as traj_mod
from .frontend import Frontend
from .map import SlamMap
from .timing import StageTimers
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
        vocabulary,  # must be None: relocalization/loop closing not ported
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
        if vocabulary is not None:
            raise _not_ported("place recognition with a vocabulary", "relocalization, loop closing")
        if threaded or deferred_mapping:
            raise _not_ported("local mapping", "local mapping")
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
        self.local_mapper = None  # local mapping is not ported yet
        self.timers = StageTimers()
        self.tracker.timers = self.timers

    # ------------------------------------------------------------------

    def track_stereo(self, im_left, im_right, timestamp: float):
        """Per-frame entry (reference System::TrackStereo, System.cpp:90-142).
        Returns the frame's solved Tcw [4,4], or None when tracking is lost."""
        with self.timers.span("Total tracking"):
            return self.tracker.track(im_left, im_right, timestamp)

    def reset(self):
        """Full tracking reset (reference Tracking::Reset, Tracking.cpp:1348-1388)."""
        self.tracker.reset()

    def shutdown(self) -> str:
        """Return the stage-timing report (reference System.cpp:244)."""
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
