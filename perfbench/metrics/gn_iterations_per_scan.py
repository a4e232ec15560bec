"""gn_iterations_per_scan: the front end's Gauss-Newton iterations
(`scan_match.scan_to_map` under the program's span `scan_to_map`) per
scan of the profiled session: the program's counter `gn_iterations` kept
by that span over `scans` (lis_slam_torch/utils/profiling.py), which
count only while the profiler records. Each iteration is a K2 launch and
a host wait. Null where the program has no such counters, where the span
counted none, or where the counters did not count the profiled session's
scans. Moves scans_per_s."""

from perfbench.metrics.host_syncs_per_scan import counters


def read(run):
    c, front = counters(), counters("scan_to_map")
    if c is None or not run.trace_scans or c.get("scans") != run.trace_scans:
        return None
    its = front.get("gn_iterations", 0)
    return its / run.trace_scans if its else None
