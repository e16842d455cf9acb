"""Per-stage timing instrumentation.

Port of orbslam2_tpu/slam/timing.py::StageTimers (the reference's
hand-rolled profiling, SURVEY.md §5): named microsecond spans collected in
per-stage vectors and reduced to mean/stddev at shutdown (reference
mean_stddev_time, src/LoopClosing.cpp:3-14; report format at
src/System.cpp:244-258). A copy, so that the port imports nothing of the
JAX package; the JAX module's `trace()` wraps `jax.profiler` and has no
counterpart here (`torch.profiler` is used directly).
"""

from __future__ import annotations

import contextlib
import time
from collections import OrderedDict


class StageTimers:
    def __init__(self):
        self.samples: "OrderedDict[str, list[float]]" = OrderedDict()

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.samples.setdefault(name, []).append((time.perf_counter() - t0) * 1e6)

    def mean_stddev(self, name: str):
        v = self.samples.get(name, [])
        if not v:
            return 0.0, 0.0
        n = len(v)
        mean = sum(v) / n
        var = sum((x - mean) ** 2 for x in v) / n
        return mean, var**0.5

    def report(self) -> str:
        """Shutdown report in the reference's format (System.cpp:244-258)."""
        lines = ["TIME STATS (microseconds): mean +- stddev [n]"]
        for name, v in self.samples.items():
            mean, std = self.mean_stddev(name)
            lines.append(f"  {name}: {mean:.1f} +- {std:.1f} [{len(v)}]")
        return "\n".join(lines)
