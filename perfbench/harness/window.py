"""The measured window: sessions back to back, closed loop, from the end
of set-up until the first session to end after `--seconds`, and what the
metrics read from it.

The probes keep the answers and problems the check reads (`capture`) only
in sessions that may be the window's last: those that start less than
twice the longest session yet (the warm-up's included) before the
window's end, and the window's first (in a traced run, the profiled one).
The check judges the last such session: the window's last, unless that
one ran over twice as long as any before it. What a cell's checks kept of
a captured session is its `checks`."""

from __future__ import annotations

import math
import os
import time
from dataclasses import dataclass, field

from . import bounds
from .trace import TraceSummary, profiled


@dataclass
class RunRecord:
    scans: int = 0
    window_s: float = 0.0
    latencies_s: list = field(default_factory=list)
    session_s: list = field(default_factory=list)  # each session's wall
    # its process's user and system CPU seconds
    session_cpu_s: list = field(default_factory=list)
    session_p50_ms: list = field(default_factory=list)  # its median scan
    # host spans of the unprofiled sessions: stage -> [count, total s],
    # the IMU chain's seconds, and the scans they cover
    stage_s: dict = field(default_factory=dict)
    imu_s: float = 0.0
    span_scans: int = 0
    last: object = None  # the last session (harness/program.Session)
    judged: object = None  # the last session that kept its answers
    trace: TraceSummary | None = None
    trace_scans: int = 0
    trace_reduce_s: float = 0.0
    kernel_bound_s: dict = field(default_factory=dict)  # K1/K2 -> seconds

    def add(self, s, profiled: bool = False):
        """Count a session of the window. The host spans of a profiled
        session (the profiler slows the host) are left out of the stage
        totals, which the per-layer metrics read over the other
        sessions."""
        self.scans += s.scans
        self.latencies_s.extend(s.latencies_s)
        self.session_s.append(s.wall_s)
        self.session_cpu_s.append(s.cpu_s)
        lat = sorted(s.latencies_s)
        self.session_p50_ms.append(1e3 * lat[len(lat) // 2] if lat
                                   else math.nan)
        if not profiled:
            self.span_scans += s.scans
            self.imu_s += s.imu_s
            for k, (n, t) in s.stage_s.items():
                acc = self.stage_s.setdefault(k, [0, 0.0])
                acc[0] += n
                acc[1] += t
        self.last = s
        if s.captured:
            self.judged = s


def _launch_counts():
    from lis_slam_torch.ops import gn_cuda, gn_solve, knn_cuda

    return {"K1": knn_cuda.knn.launches,
            "K2": gn_cuda.gn_iteration_vec.launches,
            "K3": gn_solve.solve.launches}


def kernel_bounds(log: list, counted: dict) -> dict:
    """Sum of each launch's least time, by kernel, over the launches the
    probes saw; a kernel whose launches the probes did not all see (its
    program counter moved by another count) is left out."""
    out, seen = {}, {}
    for entry in log:
        tag, lanes = entry[0], entry[1]
        seen[tag] = seen.get(tag, 0) + 1
        if tag == "K3":
            st, solves = entry[2:]
            lanes = st.pose.shape[0]
            active = int((~st.converged).sum())
            t = bounds.k3_bound_s(lanes, active, solves)
        elif tag == "K1":
            q, ref, mask, k, cap = entry[2:]
            if lanes:
                t = sum(bounds.k1_bound_s(q[b], ref[b], mask[b], k, cap)
                        for b in range(q.shape[0]))
            else:
                t = bounds.k1_bound_s(q, ref, mask, k, cap)
        else:
            corner, surf, k = entry[2:]
            n_lanes = corner[0].shape[0] if lanes else 1
            t = bounds.k2_bound_s([corner, surf], k, n_lanes)
        out[tag] = out.get(tag, 0.0) + t
    return {tag: t for tag, t in out.items()
            if seen.get(tag) == counted.get(tag)}


def run_window(sessions, probes, seconds: float, trace: bool,
               sample: set, warm_s: float = 0.0) -> RunRecord:
    """Run sessions until `seconds` have passed and the session in flight
    has ended. With `trace`, the first session runs under the profiler and
    its kernel launches are logged. `warm_s`: the warm-up session's wall
    seconds."""
    rec = RunRecord()
    probes.sample = set(sample)
    longest = warm_s
    t0 = time.perf_counter()
    first = True
    while True:
        under_profiler = trace and first
        # the first session too, so that one is kept whatever comes
        capture = (first or
                   time.perf_counter() - t0 + 2.0 * longest >= seconds)
        if under_profiler:
            before = _launch_counts()
            probes.kernel_log = []
            s, rec.trace, rec.trace_reduce_s = profiled(
                lambda: sessions.run(traced=True, capture=capture))
            log, probes.kernel_log = probes.kernel_log, None
            after = _launch_counts()
            rec.trace_scans = s.scans
            t_pause = time.perf_counter()
            rec.kernel_bound_s = kernel_bounds(
                log, {k: after[k] - before[k] for k in after})
            del log
            # the reduction and the bounds are not part of the window
            t0 += time.perf_counter() - t_pause + rec.trace_reduce_s
        else:
            c0 = os.times()
            s = sessions.run(capture=capture)
            c1 = os.times()
            s.cpu_s = (c1.user - c0.user, c1.system - c0.system)
            longest = max(longest, s.wall_s)
        if capture:
            s.checks = probes.checks
        first = False
        rec.add(s, under_profiler)
        if time.perf_counter() - t0 >= seconds:
            break
    rec.window_s = time.perf_counter() - t0
    return rec
