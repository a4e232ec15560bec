"""rangenet_device_ms: the device time of RangeNet's labelling of a
keyframe (projection, image, net, argmax, readback), ms a forward in the
profiled session: the seconds of the device operations launched inside
the program's span `rangenet` (harness/trace.py `stage_device_s`, a
graph's kernels charged to the stage of their `cudaGraphLaunch`) over
the program's counter `rangenet_forwards` (lis_slam_torch/utils/
profiling.py). Null where the program has no such counter or span, or
where no forward ran. Moves scans_per_s."""

from perfbench.metrics.host_syncs_per_scan import counters


def read(run):
    t, c = run.trace, counters()
    if t is None or c is None or not c.get("rangenet_forwards"):
        return None
    s = t.stage_device_s.get("rangenet")
    return 1e3 * s / c["rangenet_forwards"] if s else None
