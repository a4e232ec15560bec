"""preprocess_device_ms: the device time of the front end's preprocessing
(`odometry.preprocess`: pretreatment, deskew, projection, features; on
the card CUDA-graph replays), ms a scan of the profiled session: the
seconds of the device operations launched inside the program's span
`preprocess` (harness/trace.py `stage_device_s`, a graph's kernels
charged to the stage of their `cudaGraphLaunch`) over the session's
scans. Where preprocess_ms is the host's time in the span, this is the
card's work for it, the yardstick of a fused projection-and-features
kernel. Null where no operation was launched inside the span. Moves
scans_per_s."""


def read(run):
    t = run.trace
    if t is None or not run.trace_scans:
        return None
    s = t.stage_device_s.get("preprocess")
    return 1e3 * s / run.trace_scans if s else None
