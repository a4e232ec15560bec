"""rangenet_roofline: RangeNet's labelling of the profiled session's
keyframes against the net's least time, in %: forwards x the least time
of one forward (perfbench/reference/rangenet.py `least_seconds`:
max(operations / 989.4 TFLOP/s at the bf16 peak, bytes / 3.35 TB/s),
counted by the benchmark from the architecture and the image size that
the check `rangenet_logits` captured of the program's calls) over the
device time of the span `rangenet` (as rangenet_device_ms reads it).
The device time holds the projection, the argmax and the readback
besides the net, which the least time leaves out. Null where the program
has no such counter or span, or where the check kept nothing. Moves
scans_per_s."""

from perfbench.metrics.host_syncs_per_scan import counters


def read(run):
    t, c = run.trace, counters()
    judged = run.judged or run.last
    kept = getattr(judged, "checks", {}).get("rangenet_logits")
    if t is None or c is None or not c.get("rangenet_forwards") or not kept:
        return None
    s = t.stage_device_s.get("rangenet")
    if not s:
        return None
    from perfbench.reference import rangenet as R

    h, w = kept[0]["image"].shape[:2]
    least = c["rangenet_forwards"] * R.least_seconds(kept[0]["arch"], h, w)
    return 100.0 * least / s
