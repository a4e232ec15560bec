"""gn_device_solve_share: the share of the profiled session's
Gauss-Newton iterations of `scan_match.scan_to_map` (every call: the
front end, the semantic refinement, the submap registrations) whose solve
ran on the card as kernel K3: the program's counters `gn_device_solves`
over `gn_iterations` (lis_slam_torch/utils/profiling.py), which count
only while the profiler records. Null where the program has no such
counter, or where no iteration ran. Moves scans_per_s."""

from perfbench.metrics.host_syncs_per_scan import counters


def read(run):
    c = counters()
    if c is None or c.get("gn_device_solves") is None:
        return None
    its = c.get("gn_iterations")
    return c["gn_device_solves"] / its if its else None
