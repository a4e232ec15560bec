"""launches_per_scan: CUDA kernel activities (copies and sets left out)
in the profiled session, per scan of it. Moves scans_per_s: the step is
bound by launching."""


def read(run):
    if run.trace is None or not run.trace_scans:
        return None
    return run.trace.launches / run.trace_scans
