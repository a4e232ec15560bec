"""scan_to_map_ms: the front end's scan-to-map solve
(`scan_match.scan_to_map` as `odometry._odom_step_impl` calls it: K1, the
GN iterations through K2, a host 6x6 solve each), ms a scan: the
program's span `scan_to_map` in SemanticSlam.timer, summed over the
window's sessions that ran without the profiler, over their scans. A
host-clock stage that launches and waits once an iteration: device work
launched before it and not waited on is charged to it, and its own
launches not waited on to the stage that waits. Moves scans_per_s."""


def read(run):
    st = run.stage_s.get("scan_to_map")
    if not st or not run.span_scans:
        return None
    return 1e3 * st[1] / run.span_scans
