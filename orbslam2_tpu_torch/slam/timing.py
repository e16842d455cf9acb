"""Per-stage timing instrumentation.

Port of orbslam2_tpu/slam/timing.py::StageTimers (the reference's
hand-rolled profiling, SURVEY.md §5): named microsecond spans collected in
per-stage vectors and reduced to mean/stddev at shutdown (reference
mean_stddev_time, src/LoopClosing.cpp:3-14; report format at
src/System.cpp:244-258), and the reference's 20 stage names. A copy, so
that the port imports nothing of the JAX package; the JAX module's
`trace()` wraps `jax.profiler` and has no counterpart here
(`torch.profiler` is used directly). Spans are recorded
under a lock: the tracker, the mapping worker, the loop worker and the
global BA's thread time their stages into one `StageTimers`.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import OrderedDict

# The reference's 20 stage names (tracking 7, local mapping 6, loop 7)
TRACKING_STAGES = (
    "ORB extraction",
    "Stereo matching",
    "Pose prediction",
    "Relocalization",
    "Local map tracking",
    "New keyframe decision",
    "New keyframe creation",
)
LOCAL_MAPPING_STAGES = (
    "Keyframe insertion",
    "Map point culling",
    "Map point creation",
    "Map point fusion",
    "Local BA",
    "Keyframe culling",
)
LOOP_CLOSING_STAGES = (
    "Loop detection",
    "Sim3 computation",
    "Sim3 detection",
    "Loop fusion",
    "Essential graph",
    "Global BA",
    "Graph update",
)


class StageTimers:
    def __init__(self):
        self.samples: "OrderedDict[str, list[float]]" = OrderedDict()
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(name, (time.perf_counter() - t0) * 1e6)

    def add(self, name: str, micros: float):
        with self._lock:
            self.samples.setdefault(name, []).append(micros)

    def mean_stddev(self, name: str):
        with self._lock:
            v = list(self.samples.get(name, []))
        return _mean_stddev(v)

    def report(self) -> str:
        """Shutdown report in the reference's format (System.cpp:244-258)."""
        lines = ["TIME STATS (microseconds): mean +- stddev [n]"]
        with self._lock:
            stages = [(name, list(v)) for name, v in self.samples.items()]
        for name, v in stages:
            mean, std = _mean_stddev(v)
            lines.append(f"  {name}: {mean:.1f} +- {std:.1f} [{len(v)}]")
        return "\n".join(lines)


def _mean_stddev(v):
    if not v:
        return 0.0, 0.0
    n = len(v)
    mean = sum(v) / n
    var = sum((x - mean) ** 2 for x in v) / n
    return mean, var**0.5
