"""Threaded pipeline runtime: mapping and loop-closing worker threads.

This file is a copy of orbslam2_tpu/slam/pipeline.py, which imports no
JAX; the port carries its own so that it imports nothing of the JAX
package, and tests/test_torch_imports.py holds the two equal below their
docstrings. `System(threaded=True)` runs the local mapper on a
`MappingWorker` thread (reference src/System.cpp:63-65) and, with loop
closing, the loop closer on a `LoopWorker` thread (:66-70).

The synchronization fabric is the single map-update lock (reference
mMutexMapUpdate, Tracking.cpp:260) plus the convention that long device
solves (local BA) run outside it, so the tracker's frame latency is
bounded by the worker's host sections, never by a bundle adjustment. The
worker's CUDA work goes to the same device and stream as the tracker's.
A stop request (reference LocalMapping::RequestStop) parks the mapping
worker with its queue intact until it is released.
"""

from __future__ import annotations

import threading
import time


class _StageWorker:
    """Base: a daemon thread draining a work queue one item at a time."""

    def __init__(self, name: str):
        self._cv = threading.Condition()
        self._stop = False
        self._busy = False
        self._error = None
        self._thread = threading.Thread(target=self._run, name=name, daemon=True)

    # -- subclass interface ------------------------------------------------

    def _has_work(self) -> bool:
        raise NotImplementedError

    def _parked(self) -> bool:
        """True when the worker must idle even though work is queued
        (reference LocalMapping::isStopped)."""
        return False

    def _step(self):
        raise NotImplementedError

    # -- public API --------------------------------------------------------

    def notify(self):
        with self._cv:
            self._cv.notify()

    def idle(self) -> bool:
        return not self._busy and not self._has_work()

    def wait_idle(self, timeout: float = 60.0):
        """Block until the queue is drained (shutdown barrier — reference
        System::Shutdown spin-wait, System.cpp:239-242)."""
        t0 = time.monotonic()
        while not self.idle():
            if self._error is not None:
                raise self._error
            if time.monotonic() - t0 > timeout:
                raise TimeoutError(f"{self._thread.name} did not drain in time")
            time.sleep(0.002)
        if self._error is not None:
            raise self._error

    def wait_parked(self, timeout: float = 60.0):
        """Block until the worker is not mid-step (reference CorrectLoop's
        isStopped() spin-wait, LoopClosing.cpp:412-415). Call after
        arranging `_parked()` to hold, or the worker may pick up new work."""
        t0 = time.monotonic()
        while self._busy:
            if time.monotonic() - t0 > timeout:
                raise TimeoutError(f"{self._thread.name} did not park in time")
            time.sleep(0.002)

    def finish(self):
        """Stop the thread after draining the queue (RequestFinish)."""
        with self._cv:
            self._stop = True
            self._cv.notify()
        self._thread.join(timeout=300.0)
        if self._error is not None:
            raise self._error

    # -- internals ---------------------------------------------------------

    def _run(self):
        while True:
            with self._cv:
                while not self._stop and (not self._has_work() or self._parked()):
                    self._cv.wait(timeout=0.01)
                if self._stop and (not self._has_work() or self._parked()):
                    return
                self._busy = True
            try:
                self._step()
            except Exception as e:  # surface in wait_idle/finish
                self._error = e
                self._drop_work()
            finally:
                self._busy = False

    def _drop_work(self):
        pass


class MappingWorker(_StageWorker):
    """Background thread draining the LocalMapper's keyframe queue
    (reference LocalMapping::Run poll loop, LocalMapping.cpp:22-107, with
    a condition variable instead of the 3 ms sleep)."""

    def __init__(self, local_mapper):
        super().__init__("mapping-worker")
        self.lm = local_mapper
        self.lm.worker = self
        self._thread.start()

    def _has_work(self) -> bool:
        return bool(self.lm._queue)

    def _parked(self) -> bool:
        # reference Stop(): a stop request parks the thread with its queue
        # intact until Release() (LocalMapping.cpp:534-607)
        return self.lm._stopped

    def _step(self):
        self.lm.pump()

    def _drop_work(self):
        self.lm._queue.clear()

    def idle(self) -> bool:
        return not self._busy and not self.lm._queue


class LoopWorker(_StageWorker):
    """Loop-closing thread (reference LoopClosing::Run, LoopClosing.cpp:
    38-75): consumes keyframes the mapping worker finished processing."""

    def __init__(self, closer):
        super().__init__("loop-worker")
        self.closer = closer
        self._queue = []
        self._thread.start()

    def submit(self, kf: int):
        with self._cv:
            self._queue.append(kf)
            self._cv.notify()

    def _has_work(self) -> bool:
        return bool(self._queue)

    def _step(self):
        self.closer.insert_keyframe(self._queue.pop(0))

    def _drop_work(self):
        self._queue.clear()
