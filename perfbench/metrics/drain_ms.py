"""drain_ms: the session driver's deferred back end (`SemanticSlam._drain`:
fetch of the previous window, keyframes, loop scoring and verification,
submaps, graph), mean ms a drain over the window's sessions that ran
without the profiler: SemanticSlam.timer's stage `drain`. One scan in
`drain_every` carries it, so it sets the per-scan tail. Moves
scan_ms_p95."""


def read(run):
    st = run.stage_s.get("drain")
    if not st or not st[0]:
        return None
    return 1e3 * st[1] / st[0]
