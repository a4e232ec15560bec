"""preprocess_replay_share: the share of the profiled session's
preprocessing calls (`pipeline/odometry.preprocess`) that CUDA-graph
replays gave whole: the program's counters `preprocess_replays` over
`preprocess_replays` + `preprocess_eager` (lis_slam_torch/utils/
profiling.py), which count only while the profiler records. A call runs
eagerly where its graph is not captured yet, which the warm-up session
does. Null where the program has no such counters, or where they counted
no call. Moves scans_per_s."""

from .host_syncs_per_scan import counters


def read(run):
    c = counters()
    if c is None:
        return None
    replays = c.get("preprocess_replays")
    eager = c.get("preprocess_eager")
    if replays is None or eager is None or replays + eager == 0:
        return None
    return replays / (replays + eager)
