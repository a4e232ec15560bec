"""rangenet_replay_share: the share of the profiled session's keyframe
labellings (`slam.slam_step`'s RangeNet forwards) that a CUDA-graph
replay gave whole: the program's counters `rangenet_replays` over
`rangenet_forwards` (lis_slam_torch/utils/profiling.py), which count only
while the profiler records. A labelling runs eagerly at its graph's
first call, which the warm-up session makes, or off the net's own
projection. Null where the program has no such counters, or where no
forward ran. Moves scans_per_s."""

from perfbench.metrics.host_syncs_per_scan import counters


def read(run):
    c = counters()
    if c is None or not c.get("rangenet_forwards"):
        return None
    return c.get("rangenet_replays", 0) / c["rangenet_forwards"]
