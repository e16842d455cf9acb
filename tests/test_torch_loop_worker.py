"""The port's loop closing on its own thread (`System(threaded=True)` with a
vocabulary): the global BA on a thread of its own with the abort-and-join
protocol of the reference (LoopClosing.cpp:397-409, 566-570), the
`LoopWorker` wiring, and reset. The port's analog of the JAX package's
tests/test_pipeline.py::TestConcurrentGBA, with the global BA's solve
stubbed (the threaded circuit itself runs on the card in chip_smoke.py).
"""

import threading
import time
import types

import numpy as np
import torch
from _torch_parity import slam_config

from orbslam2_tpu_torch import config as torch_config
from orbslam2_tpu_torch.datasets.synthetic import SyntheticWorld
from orbslam2_tpu_torch.slam import loop_closing as lc_mod
from orbslam2_tpu_torch.slam.pipeline import LoopWorker
from orbslam2_tpu_torch.slam.system import System
from orbslam2_tpu_torch.vocab import bow


def _system(threaded=True):
    """A CPU System with loop closing on a two-word vocabulary."""
    cd = np.zeros((3, 2, 8), np.uint32)
    cd[0, 1] = 0xFFFFFFFF
    voc = bow.from_arrays(cd, np.array([[1, 2], [-1, -1], [-1, -1]], np.int32), np.array([-1, 0, 1], np.int32),
                          np.ones(2, np.float32), 2, 1, "cpu")
    cfg = slam_config(SyntheticWorld(n_points=10, seed=0), torch_config)
    return System(voc, cfg, threaded=threaded, device="cpu")


def _fake_gba(lc, started):
    def gba(kf):
        started.set()
        while not lc._gba_stop:  # the solve polls the flag between chunks
            time.sleep(0.002)
    return gba


def test_gba_thread_overlaps_detection_and_a_correction_aborts_it(monkeypatch):
    s = _system()
    lc = s.loop_closer
    assert lc.threaded_gba
    started = threading.Event()
    monkeypatch.setattr(lc, "_global_ba", _fake_gba(lc, started))
    lc._start_gba(7)
    assert started.wait(5.0) and lc.gba_running()

    # loop detection goes on while the global BA runs
    detect_calls = []
    monkeypatch.setattr(lc, "_detect_loop", lambda kf: detect_calls.append(kf) and False)
    s.map.kf_valid.add_range(0, 20)
    t0 = time.monotonic()
    assert lc.insert_keyframe(15) is False
    assert time.monotonic() - t0 < 2.0 and detect_calls == [15] and lc.gba_running()

    # a new correction stops and joins the running global BA before it
    # rewrites the map, then starts its own
    seen = {}

    def locked(kf):
        seen["gba_running_at_rewrite"] = lc.gba_running()
        return ({}, {}), ([kf], {}, {}, np.zeros(0, np.int64), [])

    monkeypatch.setattr(lc, "_correct_loop_locked", locked)
    monkeypatch.setattr(lc, "_search_and_fuse", lambda kf, *a: {})
    monkeypatch.setattr(lc, "_optimize_essential_graph", lambda kf, *a: None)
    first = lc._gba_thread
    started.clear()
    lc._correct_loop(16)
    assert seen == {"gba_running_at_rewrite": False} and not first.is_alive()
    assert started.wait(5.0) and lc.gba_running() and lc._gba_thread is not first
    assert lc.n_loops_closed == 1 and len(lc.correction_windows) == 1
    assert not s.local_mapper.is_stopped()
    lc._abort_gba_and_join(timeout=5.0)
    assert not lc.gba_running()
    s.shutdown()


def test_inline_gba_when_unthreaded(monkeypatch):
    s = _system(threaded=False)
    lc = s.loop_closer
    assert not lc.threaded_gba and s.loop_worker is None
    calls = []
    monkeypatch.setattr(lc, "_global_ba", lambda kf: calls.append(kf))
    lc._start_gba(3)
    assert calls == [3] and not lc.gba_running()


def test_threaded_system_wiring_reset_and_shutdown(monkeypatch):
    s = _system()
    assert isinstance(s.loop_worker, LoopWorker) and s.worker is not None
    assert s.local_mapper.on_processed == s.loop_worker.submit
    assert s.loop_closer.on_pose_jump == s.tracker.apply_pose_jump
    lc = s.loop_closer
    started = threading.Event()
    monkeypatch.setattr(lc, "_global_ba", _fake_gba(lc, started))
    lc._start_gba(4)
    assert started.wait(5.0)
    # a parked loop worker keeps its queue until reset empties it
    gate = threading.Event()
    monkeypatch.setattr(lc, "insert_keyframe", lambda kf: gate.wait(5.0))
    for kf in (1, 2, 3):
        s.loop_worker.submit(kf)
    s.reset()
    assert not lc.gba_running() and lc._gba_thread is None
    assert s.loop_worker._queue == []
    gate.set()
    s.wait_idle(10.0)
    s.shutdown()
    assert s.loop_worker is None and s.worker is None
    assert not any(t.name == "gba-thread" and t.is_alive() for t in threading.enumerate())


def test_aborted_gba_is_discarded_even_while_the_lock_is_held(monkeypatch):
    """The tracker's early-loss reset stops and joins the global BA while it
    holds the map lock: a solve waiting for the lock gives up, and its
    result is never applied."""
    s = _system()
    lc = s.loop_closer
    m = s.map
    m.kf_valid.add_range(0, 3)
    m.pt_valid.add_range(0, 12)
    solved, go, applied = threading.Event(), threading.Event(), []
    prob = types.SimpleNamespace(edge_valid=torch.ones(4, dtype=torch.bool))
    monkeypatch.setattr(lc_mod, "assemble_pm_problem", lambda *a: (prob, None))
    monkeypatch.setattr(lc_mod.convert, "ba_problem_pm_to_torch", lambda prob, dev: prob)

    def solve(prob, cam, should_abort=None, **kw):
        assert should_abort is not None and not should_abort()
        solved.set()
        go.wait(5.0)
        return "result"

    monkeypatch.setattr(lc_mod.ba, "ba_solve_pm_interruptible", solve)
    monkeypatch.setattr(lc, "_apply_gba_staged", lambda *a: applied.append(a))
    with m.lock:
        lc._start_gba(2)
        # the thread assembles only once it holds the lock: it waits
        time.sleep(0.05)
        assert lc.gba_running() and not solved.is_set()
    assert solved.wait(5.0)
    with m.lock:
        go.set()
        time.sleep(0.05)  # the solve is done: the thread waits for the lock
        assert lc.gba_running()
        t0 = time.monotonic()
        s.reset()  # as the tracker's early-loss reset does, under the lock
        assert time.monotonic() - t0 < 2.0
    assert not lc.gba_running() and applied == [] and lc.n_gba_aborted == 1
    s.shutdown()
