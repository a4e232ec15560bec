"""The traced session: torch.profiler around one whole session, reduced to
the device's busy time, its idle gaps labelled by what the host was doing,
the device operations by time, each kernel's device time, every device
operation's time by name, and the device time of each stage.

The host spans that label the gaps are the benchmark's own: `bench:scan`
and `bench:finish` around the calls into the program, and `stage:<name>`
around each stage of the session's StageTimer (harness/probes.py) and the
program's own spans (lis_slam_torch/utils/profiling.py).

A stage's device time is that of the operations whose launch call (a CUDA
runtime or driver call: `cudaLaunchKernel`, `cudaMemcpyAsync`,
`cuLaunchKernel`, ...) lay inside it, its innermost `stage:<name>` range,
matched to the operation through the profiler's correlation id: an
operation is charged to the stage that launched it, not to the stage open
while it runs. The kernels of a CUDA-graph replay carry the correlation id
of their `cudaGraphLaunch`, so they go to its stage. What was launched
outside every stage, or whose launch the trace does not hold, goes to
`UNATTRIBUTED`."""

from __future__ import annotations

import time
from dataclasses import dataclass, field

from . import stats

K1_KERNELS = ("knn_prepass_kernel", "knn_tiles_kernel")
K2_KERNELS = ("gn_iteration_kernel",)
K3_KERNELS = ("gn_solve_kernel",)
UNATTRIBUTED = "unattributed"


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    launches: int  # CUDA kernel activities
    device_ops: list  # [(name, seconds)], the most time first
    idle_gaps: list  # [(host label, seconds)], the most time first
    kernel_s: dict = field(default_factory=dict)  # K1/K2/K3 -> device s
    # every device operation's seconds by its full name
    kernel_names_s: dict = field(default_factory=dict)
    # stage that launched it (or UNATTRIBUTED) -> device seconds
    stage_device_s: dict = field(default_factory=dict)


def _ns(ev, what: str) -> int:
    f = getattr(ev, f"{what}_ns", None)
    if f is not None:
        return int(f())
    return int(getattr(ev, f"{what}_us")() * 1000)


def _short(name: str) -> str:
    name = name.split("(")[0]
    return name if len(name) <= 60 else name[:57] + "..."


def stage_device_seconds(events, lo: int, hi: int) -> tuple[dict, dict]:
    """(device seconds by the stage that launched them, device seconds by
    operation name) over `events`, tuples (name, start ns, end ns,
    correlation id, "host" or "device"). Host events are `stage:<name>`
    ranges or launch calls; a device operation counts its time inside
    [lo, hi] and is charged to the innermost stage range open at the start
    of the launch call with its correlation id, or to UNATTRIBUTED. The
    two dicts hold the same seconds, grouped two ways."""
    ranges, launches, ops = [], {}, []
    for name, s, e, corr, where in events:
        if where == "device":
            if e > lo and s < hi:
                ops.append((name, (min(e, hi) - max(s, lo)) / 1e9, corr))
        elif name.startswith("stage:"):
            ranges.append((s, -e, name[6:]))  # outer first at one start
        else:
            launches[corr] = s
    ranges.sort()
    # the launches in time order, with the ranges opened so far: the
    # innermost range open at a launch is the last opened that has not
    # ended
    stage_of, opened, i = {}, [], 0
    for t, corr in sorted((s, c) for c, s in launches.items()):
        while i < len(ranges) and ranges[i][0] <= t:
            opened.append(ranges[i])
            i += 1
        while opened and -opened[-1][1] <= t:
            opened.pop()
        stage_of[corr] = opened[-1][2] if opened else UNATTRIBUTED
    by_stage, by_name = {}, {}
    for name, d, corr in ops:
        st = stage_of.get(corr, UNATTRIBUTED)
        by_stage[st] = by_stage.get(st, 0.0) + d
        by_name[name] = by_name.get(name, 0.0) + d
    return by_stage, by_name


def summarize(prof, span_name: str = "bench:session") -> TraceSummary:
    """Reduce a finished torch.profiler.profile to a TraceSummary over the
    host span `span_name`."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    dev_iv, dev_ev, host, attrib = [], [], [], []
    span = None
    for ev in prof.profiler.kineto_results.events():
        s = _ns(ev, "start")
        e = s + _ns(ev, "duration")
        name = ev.name()
        if name.startswith(("stage:", "bench:")) and ev.device_type() == cuda:
            continue  # a host span's shadow on the device's timeline
        if ev.device_type() == cuda:
            dev_iv.append((s, e))
            dev_ev.append((name, s, e))
            attrib.append((name, s, e, ev.correlation_id(), "device"))
        elif name == span_name:
            span = (s, e)
        elif name.startswith(("stage:", "bench:")):
            host.append((s, e, name.split(":", 1)[1]))
            if name.startswith("stage:"):
                attrib.append((name, s, e, 0, "host"))
        elif name.startswith("cu"):
            # a CUDA runtime or driver call; the program's own ops carry
            # correlation ids of another count
            attrib.append((name, s, e, ev.correlation_id(), "host"))
    if span is None:
        raise RuntimeError(f"the trace holds no {span_name!r} span")
    lo, hi = span
    dev_iv = [(max(s, lo), min(e, hi)) for s, e in dev_iv if e > lo and s < hi]
    busy = stats.busy_seconds(dev_iv)
    ops, kernel_s, launches = {}, {}, 0
    for name, s, e in dev_ev:
        if e <= lo or s >= hi:
            continue
        d = (min(e, hi) - max(s, lo)) / 1e9
        ops[_short(name)] = ops.get(_short(name), 0.0) + d
        if not name.startswith(("Memcpy", "Memset")):
            launches += 1
        for tag, names in (("K1", K1_KERNELS), ("K2", K2_KERNELS),
                           ("K3", K3_KERNELS)):
            if any(n in name for n in names):
                kernel_s[tag] = kernel_s.get(tag, 0.0) + d
    # label each gap by the innermost host span open at its midpoint
    host.sort()
    labels = {}
    for a, b in stats.idle_gaps(dev_iv, lo, hi):
        mid = (a + b) / 2
        label, best = "other host work", None
        for s, e, name in host:
            if s > mid:
                break
            if e > mid and (best is None or s >= best):
                label, best = name, s
        labels[label] = labels.get(label, 0.0) + (b - a) / 1e9
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(labels.items(), key=lambda kv: -kv[1])[:10]
    stage_s, names_s = stage_device_seconds(attrib, lo, hi)
    return TraceSummary(window_s=(hi - lo) / 1e9, busy_s=busy / 1e9,
                        launches=launches, device_ops=[list(t) for t in top],
                        idle_gaps=[list(g) for g in gaps], kernel_s=kernel_s,
                        kernel_names_s=names_s, stage_device_s=stage_s)


def profiled(fn):
    """Run fn() under the profiler inside a `bench:session` span; returns
    (fn's result, TraceSummary, seconds the profiler took after fn: its
    stop and the reduction)."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function("bench:session"):
            out = fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
    summary = summarize(prof)
    return out, summary, time.perf_counter() - t
