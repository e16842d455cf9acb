"""The threaded tracker's wait for a slot in the mapper's keyframe queue
(`LocalMapper.wait_for_room`): a frame waits while QUEUE_LIMIT keyframes
wait for the mapping worker, and goes on once the worker takes one, stops,
or fails on one. Inline mapping never waits.
"""

import sys
import threading
import time

import numpy as np
import pytest
from _torch_parity import slam_config

from orbslam2_tpu_torch import config as torch_config
from orbslam2_tpu_torch.datasets.synthetic import SyntheticWorld
from orbslam2_tpu_torch.slam.local_mapping import QUEUE_LIMIT
from orbslam2_tpu_torch.slam.system import System


def _system(threaded=True):
    """A CPU System without a vocabulary (no loop closing)."""
    cfg = slam_config(SyntheticWorld(n_points=10, seed=0), torch_config)
    return System(None, cfg, threaded=threaded, device="cpu")


def _fill_queue(lm):
    """QUEUE_LIMIT + 1 keyframes: the worker takes the first and blocks in
    its (patched) `_process`; QUEUE_LIMIT stay queued."""
    for kf in range(QUEUE_LIMIT + 1):
        lm.insert_keyframe(kf)
    t_end = time.monotonic() + 5.0
    while lm.queue_size() > QUEUE_LIMIT and time.monotonic() < t_end:
        time.sleep(0.002)
    assert lm.queue_size() == QUEUE_LIMIT and not lm.has_room()


def _wait_seconds(lm) -> float:
    """Seconds `lm.wait_for_room()` took, on a thread of its own so that a
    wait that never ends fails the test (after 5 s) instead of hanging it."""
    waiter = threading.Thread(target=lm.wait_for_room, daemon=True)
    t0 = time.monotonic()
    waiter.start()
    waiter.join(5.0)
    assert not waiter.is_alive(), "wait_for_room did not return"
    return time.monotonic() - t0


def test_tracker_waits_for_a_mapper_queue_slot(monkeypatch):
    """Threaded, a frame waits while QUEUE_LIMIT keyframes wait for the
    mapper, until one is taken; not while the mapper is stopped (a loop
    correction, localization mode), and never inline."""
    s = _system()
    lm = s.local_mapper
    gate = threading.Event()
    monkeypatch.setattr(lm, "_process", lambda kf: gate.wait(10.0))
    _fill_queue(lm)
    threading.Timer(0.3, gate.set).start()
    assert 0.25 <= _wait_seconds(lm) and lm.has_room()
    s.wait_idle(10.0)

    gate.clear()
    for kf in range(QUEUE_LIMIT + 1):
        lm.insert_keyframe(kf)
    lm.request_stop()
    assert _wait_seconds(lm) < 0.1
    lm.release()
    gate.set()
    s.wait_idle(10.0)
    s.shutdown()

    inline = _system(threaded=False)
    inline.local_mapper._queue.extend(range(QUEUE_LIMIT + 1))
    assert _wait_seconds(inline.local_mapper) < 0.1
    # the tracker asks before each frame
    calls = []
    monkeypatch.setattr(inline.local_mapper, "wait_for_room", lambda: calls.append(1))
    black = np.zeros((inline.config.camera.height, inline.config.camera.width), np.uint8)
    inline.track_stereo(black, black, 0.0)
    assert calls == [1]


def test_tracker_goes_on_when_the_mapper_fails(monkeypatch):
    """A keyframe that fails in the mapper empties the queue, as the worker
    drops its work on an error: a tracker waiting for room goes on, and
    wait_idle and shutdown raise the mapper's error."""
    s = _system()
    lm = s.local_mapper
    gate = threading.Event()

    def fail(kf):
        gate.wait(10.0)
        raise RuntimeError("mapper failed")

    monkeypatch.setattr(lm, "_process", fail)
    _fill_queue(lm)
    threading.Timer(0.3, gate.set).start()
    assert 0.25 <= _wait_seconds(lm) and lm.queue_size() == 0
    with pytest.raises(RuntimeError, match="mapper failed"):
        s.wait_idle(10.0)
    with pytest.raises(RuntimeError, match="mapper failed"):
        s.shutdown()


def test_no_lost_wakeup_under_stress(monkeypatch):
    """Ten trackers, each with its own threaded mapper (20 threads on the
    machine's cores, the switch interval shortened), queue 200 keyframes
    each as fast as the wait lets them, against a mapper that takes 0.2 ms
    a keyframe: the wait blocks often, after every wait fewer than
    QUEUE_LIMIT keyframes are queued, and every tracker finishes (a lost
    notification would hang one)."""
    systems = [_system() for _ in range(10)]
    for s in systems:
        monkeypatch.setattr(s.local_mapper, "_process", lambda kf: time.sleep(2e-4))
    blocked, overflows = [], []

    def track(lm):
        for kf in range(200):
            if lm.queue_size() >= QUEUE_LIMIT:
                blocked.append(kf)
            lm.wait_for_room()
            if lm.queue_size() >= QUEUE_LIMIT:
                overflows.append(lm.queue_size())
            lm.insert_keyframe(kf)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=track, args=(s.local_mapper,), daemon=True) for s in systems]
        for t in threads:
            t.start()
        t_end = time.monotonic() + 60.0
        for t in threads:
            t.join(max(0.0, t_end - time.monotonic()))
        assert not any(t.is_alive() for t in threads), "a tracker never got room"
    finally:
        sys.setswitchinterval(interval)
    assert overflows == [] and len(blocked) > 100, (overflows, len(blocked))
    for s in systems:
        s.wait_idle(10.0)
        s.shutdown()
