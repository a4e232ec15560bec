"""fused_step_ms: the program's fused step (`slam.slam_step`: odometry,
semantic refinement and loop descriptors, RangeNet on keyframes where it
labels them), ms a scan: SemanticSlam.timer's stage `odom_step`, summed
over the sessions of the window that ran without the profiler, over
their scans. A host-clock stage
that ends in the step's own readbacks. Moves scans_per_s."""


def read(run):
    st = run.stage_s.get("odom_step")
    if not st or not run.span_scans:
        return None
    return 1e3 * st[1] / run.span_scans
