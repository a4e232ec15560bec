"""One profiled session of a benchmark cell, read through the program's
spans and counters (lis_slam_torch/utils/profiling.py).

    python3 scripts/trace_spans.py --workload hdl64_slam_gt --seed 7 \
        [--out spans_out]

Set-up and warm-up as `perfbench/run.py`, then one session of the cell's
traffic under torch.profiler (CPU and CUDA activities, inside
`bench:session`, the benchmark's probes installed). Prints one JSON line
(and writes `<out>/<workload>.json`):

- `counters`: profiling.counters(), in all and by the stage that kept them;
- `sync_calls`: the synchronizing CUDA runtime calls the profiler recorded
  inside the program's root spans, in all, by call and by the innermost
  `stage:` span around each (the cross-check of the `host_syncs` counter);
- `idle_by_label`: the card's idle seconds in the session by the
  innermost host span open at each gap's midpoint (as
  perfbench/harness/trace.py labels them, every label), and `busy_s`,
  `window_s`, `launches`;
- `stages`: the session's StageTimer totals (count, seconds), where the
  session driver keeps them.
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

ROOTS = ("process_scan", "finish", "replay_batched")  # the program's roots
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy", "cudaMemcpy2D")


def _innermost(spans, starts, t):
    """The innermost (latest-starting) of `spans` (sorted by start, whose
    starts are `starts`) open at t, or None."""
    for i in range(bisect.bisect_right(starts, t) - 1, -1, -1):
        if spans[i][1] > t:
            return spans[i][2]
    return None


def reduce_trace(prof) -> dict:
    import torch
    from perfbench.harness import stats
    from perfbench.harness.trace import _ns

    cuda = torch.autograd.DeviceType.CUDA
    host, dev_iv, syncs, launches, window = [], [], [], 0, None
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        s = _ns(ev, "start")
        e = s + _ns(ev, "duration")
        if name.startswith(("stage:", "bench:")):
            if ev.device_type() == cuda:
                continue  # a host span's shadow on the device's timeline
            if name == "bench:session":
                window = (s, e)
            host.append((s, e, name))
        elif ev.device_type() == cuda:
            dev_iv.append((s, e))
            if not name.startswith(("Memcpy", "Memset")):
                launches += 1
        elif name in SYNC_CALLS:
            syncs.append((s, name))
    host.sort()
    host_starts = [h[0] for h in host]
    lo, hi = window
    dev_iv = [(max(s, lo), min(e, hi)) for s, e in dev_iv if e > lo and s < hi]
    idle = {}
    for a, b in stats.idle_gaps(dev_iv, lo, hi):
        label = _innermost(host, host_starts, (a + b) / 2)
        label = label.split(":", 1)[1] if label else "other host work"
        idle[label] = idle.get(label, 0.0) + (b - a) / 1e9
    roots = [(s, e, n) for s, e, n in host if n[6:] in ROOTS
             and n.startswith("stage:")]
    stage_spans = [(s, e, n[6:]) for s, e, n in host
                   if n.startswith("stage:")]
    root_starts = [r[0] for r in roots]
    stage_starts = [r[0] for r in stage_spans]
    in_roots = [(t, n) for t, n in syncs
                if _innermost(roots, root_starts, t)]
    by_call, by_stage = {}, {}
    for t, n in in_roots:
        by_call[n] = by_call.get(n, 0) + 1
        st = _innermost(stage_spans, stage_starts, t)
        by_stage[st] = by_stage.get(st, 0) + 1
    return {"busy_s": stats.busy_seconds(dev_iv) / 1e9,
            "window_s": (hi - lo) / 1e9, "launches": launches,
            "idle_by_label": dict(sorted(idle.items(),
                                         key=lambda kv: -kv[1])),
            "sync_calls": {"in_roots": len(in_roots), "all": len(syncs),
                           "by_call": by_call,
                           "by_stage": dict(sorted(by_stage.items(),
                                                   key=lambda kv: -kv[1]))}}


def trace_session(cell, seed: int, device) -> dict:
    import torch
    from lis_slam_torch.utils import profiling
    from perfbench import run

    _cfg, _tr, probes, sessions, sample = run.prepare(cell, seed, device)
    try:
        probes.sample = set(sample)
        sessions.run()  # warm-up
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        profiling.reset_counters()
        with torch.profiler.profile(activities=acts) as prof:
            with torch.profiler.record_function("bench:session"):
                s = sessions.run(traced=True, capture=False)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
    finally:
        probes.uninstall()
    stages = sorted({k for k in profiling._counts if k is not None})
    out = {"workload": cell.name, "seed": seed, "scans": s.scans,
           "session_s": s.wall_s,
           "counters": {"all": profiling.counters(),
                        **{k: profiling.counters(k) for k in stages}},
           "stages": {k: list(v) for k, v in s.stage_s.items()}}
    out.update(reduce_trace(prof))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    from perfbench import run
    from perfbench.harness.spec import load_cell

    run._caches()
    run.steady()
    import torch

    torch.set_num_threads(1)
    cell = load_cell(args.workload)
    run.device_check(torch, cell.chips)
    out = trace_session(cell, args.seed, torch.device("cuda", 0))
    out["device"] = torch.cuda.get_device_name(0)
    line = json.dumps(out)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, f"{args.workload}.json"), "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
