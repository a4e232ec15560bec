"""host_syncs_per_scan: blocking waits of the host on the card inside the
program's root spans (`process_scan`, `finish`, `replay_batched`), per
scan of the profiled session: the program's counters `host_syncs` over
`scans` (lis_slam_torch/utils/profiling.py), which count only while the
profiler records, from CUDA's sync debug warnings. The benchmark's own
readbacks after `process_scan` are outside the roots; its probes' reads
inside them (one a sampled scan) are counted. Null where the program has
no such counters, or where they did not count the profiled session's
scans. Moves scans_per_s."""


def counters(stage=None):
    """The program's counters, or None where it has none."""
    try:
        from lis_slam_torch.utils import profiling
    except ImportError:
        return None
    read_counters = getattr(profiling, "counters", None)
    return None if read_counters is None else read_counters(stage)


def read(run):
    c = counters()
    if c is None or not run.trace_scans or c.get("scans") != run.trace_scans:
        return None
    return c.get("host_syncs", 0) / run.trace_scans
