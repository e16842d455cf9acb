"""The port's threaded and deferred mapping on the CPU.

The threaded run is the port's counterpart of tests/test_lock_holds.py
(the same world and configuration, a shorter circuit): the map lock is
instrumented before the first frame, and the mapping worker's holds must
stay host-admin sized, never the length of a device solve (matching,
triangulation, BA), which runs outside the lock. The deferred run is the
counterpart of tests/test_local_mapping.py::TestDeferredMapping on its
first 20 frames: one queued keyframe processed per tracked frame.

Stated bars: threaded (12 frames of the 80-frame circuit), tracking OK at
the end, >= 3 keyframes processed by the worker, its longest hold < 1 s
and its summed holds < 70% of the mapping stages' time; deferred, all
frames tracked, >= 2 keyframes processed, ATE RMSE < 0.08 m (the JAX
file's bars).
"""

import threading
import time
from collections import defaultdict

import numpy as np
import pytest
from _torch_parity import slam_config

from orbslam2_tpu_torch import config as torch_config
from orbslam2_tpu_torch.config import OrbConfig
from orbslam2_tpu_torch.datasets.synthetic import SyntheticWorld
from orbslam2_tpu_torch.evaluation.ate import ate_rmse
from orbslam2_tpu_torch.slam.system import System
from orbslam2_tpu_torch.slam.tracking import TrackingState

N_THREADED = 12
N_DEFERRED = 20


class InstrumentedRLock:
    """RLock proxy recording outermost-hold durations per thread."""

    def __init__(self):
        self._lk = threading.RLock()
        self._depth = defaultdict(int)
        self._t0 = {}
        self.holds = defaultdict(list)  # thread name -> [seconds]

    def acquire(self, *a, **kw):
        got = self._lk.acquire(*a, **kw)
        tid = threading.get_ident()
        if self._depth[tid] == 0:
            self._t0[tid] = time.monotonic()
        self._depth[tid] += 1
        return got

    def release(self):
        tid = threading.get_ident()
        self._depth[tid] -= 1
        if self._depth[tid] == 0:
            self.holds[threading.current_thread().name].append(time.monotonic() - self._t0[tid])
        self._lk.release()

    __enter__ = acquire

    def __exit__(self, *exc):
        self.release()


@pytest.fixture(scope="module")
def threaded_run():
    world = SyntheticWorld(n_points=1500, seed=5, baseline=0.2, vertical_extent=6.0, cylinder_radius=11.0,
                           near_fraction=0.15)
    cfg = slam_config(world, torch_config)
    cfg.orb = OrbConfig(n_features=800)
    system = System(None, cfg, threaded=True, device="cpu")
    ilock = InstrumentedRLock()
    # install before the first frame: every component aliases map.lock
    system.map.lock = ilock
    system.local_mapper.lock = ilock
    for i, T in enumerate(world.trajectory_circuit(80)[:N_THREADED]):
        imL, imR = world.render_stereo(T)
        system.track_stereo(imL, imR, i / 20.0)
    system.wait_idle()
    report = system.shutdown()
    return system, ilock, report


def test_threaded_tracking_survives(threaded_run):
    system, _, report = threaded_run
    assert system.tracker.state == TrackingState.OK
    assert system.local_mapper.n_processed >= 3, system.local_mapper.n_processed
    assert system.worker is None and "Local BA" in report


def test_mapper_holds_bounded(threaded_run):
    _, ilock, _ = threaded_run
    holds = ilock.holds.get("mapping-worker", [])
    assert holds, "the mapping worker never took the map lock"
    assert max(holds) < 1.0, f"the mapping worker held the map lock {max(holds):.2f} s"


def test_solves_run_unlocked(threaded_run):
    system, ilock, _ = threaded_run
    t = system.timers.samples
    mapping_s = sum(sum(t.get(k, [])) for k in ("Map point creation", "Map point fusion", "Local BA")) / 1e6
    held_s = sum(ilock.holds.get("mapping-worker", []))
    assert mapping_s > 0
    assert held_s < 0.7 * mapping_s, f"mapping held the lock {held_s:.1f} s of {mapping_s:.1f} s"


def test_deferred_mapping_tracks():
    world = SyntheticWorld(n_points=900, seed=17, baseline=0.2)
    cfg = slam_config(world, torch_config)
    cfg.orb = OrbConfig(n_features=1000)
    system = System(None, cfg, deferred_mapping=True, device="cpu")
    poses, frames = world.render_sequence(N_DEFERRED, step=0.06)
    est = [system.track_stereo(imL, imR, i / 20.0) for i, (imL, imR) in enumerate(frames)]
    assert not system.tracker._can_fuse()
    assert sum(e is not None for e in est) == N_DEFERRED
    assert system.local_mapper.n_processed >= 2
    c = lambda T: -T[:3, :3].T @ T[:3, 3]  # noqa: E731
    assert ate_rmse(np.stack([c(e) for e in est]), np.stack([c(g) for g in poses])) < 0.08
