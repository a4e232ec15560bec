"""Per-stage wall-clock counters (the counterpart of
lis_slam_tpu/utils/profiling.py:StageTimer; the reference logs running
averages per node, e.g. subMapOptmizationNode.cpp:730-736).

A stage is timed on the host clock around the code it wraps. Device work
the stage launched and did not wait on is charged to whichever later stage
waits. The JAX module's `device_trace` has no counterpart here: use
`torch.profiler` directly.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass


@dataclass
class StageStats:
    count: int = 0
    total_s: float = 0.0
    max_s: float = 0.0

    @property
    def mean_ms(self) -> float:
        return 1e3 * self.total_s / max(self.count, 1)


class StageTimer:
    """Named stages, each with its call count, total and worst time."""

    def __init__(self):
        self.stats: dict[str, StageStats] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            s = self.stats.setdefault(name, StageStats())
            s.count += 1
            s.total_s += dt
            s.max_s = max(s.max_s, dt)

    def report(self) -> dict:
        """{stage: {"mean_ms", "count", "max_ms", "total_ms"}}, sorted."""
        return {k: {"mean_ms": v.mean_ms, "count": v.count,
                    "max_ms": v.max_s * 1e3, "total_ms": v.total_s * 1e3}
                for k, v in sorted(self.stats.items())}
