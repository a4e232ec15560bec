"""rangenet_ms: RangeNet's labelling of a keyframe (`slam.slam_step`'s
span `rangenet`: on the net's own projection one CUDA-graph replay and
its copy-out, or the eager chain), host ms a forward: the span's total
in SemanticSlam.timer over its count, summed over the window's sessions
that ran without the profiler. A host-clock stage that launches and does
not wait: the net's device time is charged to the stage that waits for
it. Moves scans_per_s."""


def read(run):
    st = run.stage_s.get("rangenet")
    if not st or not st[0]:
        return None
    return 1e3 * st[1] / st[0]
