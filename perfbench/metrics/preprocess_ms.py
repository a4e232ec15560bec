"""preprocess_ms: the front end's preprocessing (`odometry.preprocess`:
pretreatment, deskew, projection, feature extraction), ms a scan: the
program's span `preprocess` in SemanticSlam.timer, summed over the
window's sessions that ran without the profiler, over their scans. A
host-clock stage that launches and mostly does not wait: device work it
launched and did not wait on is charged to the stage that waits for it.
Moves scans_per_s."""


def read(run):
    st = run.stage_s.get("preprocess")
    if not st or not run.span_scans:
        return None
    return 1e3 * st[1] / run.span_scans
