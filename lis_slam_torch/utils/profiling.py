"""The port's tracing: per-stage wall-clock totals, profiler spans and
counters (port of lis_slam_tpu/utils/profiling.py; the reference logs
running averages per node, e.g. subMapOptmizationNode.cpp:730-736).

A stage is timed on the host clock around the code it wraps. Device work
the stage launched and did not wait on is charged to whichever later stage
waits.

`StageTimer.stage(name)` times a stage of that timer; the module-level
`span(name)` times a stage of the active timer, which an owner sets around
its work with `root(timer, name)` (SemanticSlam.process_scan and finish,
LioOdometry.process_scan, parallel/batched.replay_batched), so that
functions that take no timer (the front-end step, scan-to-map) open spans
too. Each stage keeps its parent: the stage open around its first exit.

Tracing is on exactly while a torch.profiler records; nothing else
switches it. Then every stage also opens a profiler range
`stage:<name>` on the profiler's timeline, beside the kernels it
launched, so that an idle gap of the card can be put down to a stage; a
root's range carries its keyword arguments (the scan index), which the
trace keeps when the profiler records shapes (`record_shapes=True`). The
public `record_function` drops a string argument from the trace, so the
ranges are the profiler's fast record-function guard. And the counters
count (`counters()`): process-wide, each kept also by the innermost open
stage of the active timer.

- `scans`: +1 a `process_scan`, +B a step of `replay_batched`.
- `host_syncs`: every blocking wait of the host on the card inside a root:
  CUDA's sync debug mode is "warn" while a root runs, and every warning is
  counted, not shown (0 on the CPU).
- `gn_iterations`: `scan_match.scan_to_map`'s iterations;
  `gn_device_solves`: +1 an iteration whose solve kernel K3 ran on the card
  (`scan_match._scan_to_map_on_device`).
- `preprocess_replays`: +1 an `odometry.preprocess` call that CUDA-graph
  replays gave whole (utils/graphs.py); `preprocess_eager`: +1 a call run
  eagerly (on the CPU, or at a signature's first call, which captures).
- `rangenet_forwards`: +1 a keyframe that RangeNet labelled;
  `rangenet_replays`: +1 of those whose labelling a CUDA-graph replay
  gave (semantic/inference.py `infer_own_labels`).

While tracing is off, a span costs a context lookup, a profiler-state
check and the two clock reads.

    with torch.profiler.profile(record_shapes=True) as prof:
        system.process_scan(...)
    prof.export_chrome_trace("trace.json")
    profiling.counters(), profiling.counters("scan_to_map")
"""

from __future__ import annotations

import contextlib
import contextvars
import time
import warnings
from dataclasses import dataclass

import torch
from torch._C._profiler import _RecordFunctionFast

COUNTERS = ("scans", "host_syncs", "gn_iterations", "gn_device_solves",
            "preprocess_replays", "preprocess_eager", "rangenet_forwards",
            "rangenet_replays")
_SYNC_WARNING = "called a synchronizing CUDA operation"

_active: contextvars.ContextVar = contextvars.ContextVar(
    "lis_slam_torch_active_timer", default=None)
# innermost open stage's name (None: no stage open) -> counter -> count
_counts: dict[str | None, dict[str, int]] = {}


@dataclass
class StageStats:
    count: int = 0
    total_s: float = 0.0
    max_s: float = 0.0
    parent: str | None = None  # the stage open around its first exit

    @property
    def mean_ms(self) -> float:
        return 1e3 * self.total_s / max(self.count, 1)


class _Span:
    """One stage of `timer` (None: a profiler range alone)."""

    __slots__ = ("timer", "name", "kw", "rf", "t0")

    def __init__(self, timer, name: str, kw: dict | None = None):
        self.timer, self.name, self.kw, self.rf = timer, name, kw or {}, None

    def __enter__(self):
        if torch.autograd._profiler_enabled():
            self.rf = _RecordFunctionFast(f"stage:{self.name}", (), self.kw)
            self.rf.__enter__()
        if self.timer is not None:
            self.timer._open.append(self.name)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.timer is not None:
            self.timer._close(self.name, time.perf_counter() - self.t0)
        if self.rf is not None:
            self.rf.__exit__(*exc)


class StageTimer:
    """Named stages, each with its call count, total and worst time and
    its parent; with `log_every`, every log_every-th exit of a stage logs
    its running average through `log_fn`, as the reference's "Average ...
    time" logs."""

    def __init__(self, log_every: int = 0, log_fn=print):
        self.stats: dict[str, StageStats] = {}
        self.log_every = log_every
        self.log_fn = log_fn
        self._open: list[str] = []  # open stages, innermost last

    def stage(self, name: str) -> _Span:
        return _Span(self, name)

    def _close(self, name: str, dt: float):
        self._open.pop()
        s = self.stats.get(name)
        if s is None:
            s = self.stats[name] = StageStats(
                parent=self._open[-1] if self._open else None)
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


def span(name: str) -> _Span:
    """A stage of the active timer (see `root`); without one, only the
    profiler range."""
    return _Span(_active.get(), name)


@contextlib.contextmanager
def root(timer: StageTimer, name: str, **kw):
    """Make `timer` the active timer of this context and open its stage
    `name`, whose profiler range carries `kw`. While tracing, the host's
    waits on the card inside it are counted."""
    token = _active.set(timer)
    try:
        with (_count_syncs() if torch.autograd._profiler_enabled()
              else contextlib.nullcontext()), _Span(timer, name, kw):
            yield
    finally:
        _active.reset(token)


def count(name: str, n: int = 1):
    """Add `n` to counter `name` while tracing, kept also by the innermost
    open stage of the active timer."""
    if not torch.autograd._profiler_enabled():
        return
    timer = _active.get()
    where = timer._open[-1] if timer is not None and timer._open else None
    c = _counts.setdefault(where, {})
    c[name] = c.get(name, 0) + n


def counters(stage: str | None = None) -> dict[str, int]:
    """The counts since the process started (or `reset_counters`): over
    every stage, or those kept by stage `stage`."""
    kept = [_counts.get(stage, {})] if stage is not None else _counts.values()
    out = dict.fromkeys(COUNTERS, 0)
    for c in kept:
        for k, v in c.items():
            out[k] = out.get(k, 0) + v
    return out


def reset_counters():
    _counts.clear()


@contextlib.contextmanager
def _count_syncs():
    """CUDA's sync debug mode "warn" around a block: each warning is
    counted as a host sync and not shown; other warnings pass. The mode
    and the warning filters are restored after."""

    def show(message, category, filename, lineno, file=None, line=None):
        if str(message).startswith(_SYNC_WARNING):
            count("host_syncs")
        else:
            shown(message, category, filename, lineno, file, line)

    mode = None
    with warnings.catch_warnings():
        warnings.filterwarnings("always", message=_SYNC_WARNING)
        shown, warnings.showwarning = warnings.showwarning, show
        if torch.cuda.is_available():
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("warn")
        try:
            yield
        finally:
            if mode is not None:
                torch.cuda.set_sync_debug_mode(mode)
