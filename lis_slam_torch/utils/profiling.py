"""Per-stage wall-clock counters and device traces (port of
lis_slam_tpu/utils/profiling.py; the reference logs running averages per
node, e.g. subMapOptmizationNode.cpp:730-736).

A stage is timed on the host clock around the code it wraps. Device work
the stage launched and did not wait on is charged to whichever later stage
waits. `device_trace` is the counterpart of the JAX module's
jax.profiler trace: a torch.profiler run around a block, written as a
chrome trace.
"""

from __future__ import annotations

import contextlib
import os
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
    """Named stages, each with its call count, total and worst time; with
    `log_every`, every log_every-th exit of a stage logs its running
    average through `log_fn`, as the reference's "Average ... time" logs."""

    def __init__(self, log_every: int = 0, log_fn=print):
        self.stats: dict[str, StageStats] = {}
        self.log_every = log_every
        self.log_fn = log_fn

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
            if self.log_every and s.count % self.log_every == 0:
                self.log_fn(f"Average {name} time {s.mean_ms:.2f} ms "
                            f"(n={s.count}, max={s.max_s * 1e3:.2f} ms)")

    def report(self) -> dict:
        """{stage: {"mean_ms", "count", "max_ms", "total_ms"}}, sorted."""
        return {k: {"mean_ms": v.mean_ms, "count": v.count,
                    "max_ms": v.max_s * 1e3, "total_ms": v.total_s * 1e3}
                for k, v in sorted(self.stats.items())}

    def summary(self) -> str:
        """One line per stage, the JAX module's format."""
        return "\n".join(
            f"{k:30s} mean {v['mean_ms']:8.2f} ms  n={v['count']:5d}  "
            f"max {v['max_ms']:8.2f} ms" for k, v in self.report().items())


@contextlib.contextmanager
def device_trace(logdir: str):
    """torch.profiler trace (host and, on a card, CUDA activities) around
    a block, written to `logdir/trace.json` (chrome://tracing, Perfetto)."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
