"""kf_semantic_ms: the keyframe work of the fused step after the front
end (`slam.slam_step`'s keyframe branch: RangeNet where it labels,
semantic refinement, the keyframe class clouds and the loop descriptors),
ms a scan: the program's span `kf_semantic` in SemanticSlam.timer,
summed over the window's sessions that ran without the profiler, over
all their scans (keyframes or not). A host-clock stage that launches and
mostly does not wait: device work it launched and did not wait on is
charged to the stage that waits for it. Moves scans_per_s."""


def read(run):
    st = run.stage_s.get("kf_semantic")
    if not st or not run.span_scans:
        return None
    return 1e3 * st[1] / run.span_scans
