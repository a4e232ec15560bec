"""The benchmark of lis_slam_torch: one run of one cell.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout on a machine with the cards the cell asks
for. Set-up renders the cell's traffic on the card from the seed, builds
the program's kernels (a checkout's first run compiles them into
lis_slam_torch/_build/) and runs one warm-up session of the traffic.
Then sessions run back to back, closed loop, until `--seconds` have
passed and the session in flight has ended. After the window, the
program's answers in the last session that kept them are compared with
the plain references and the true poses (harness/judge.py), and with the
cell's checks where its limits name any (perfbench/checks/), each number
beside its limit.

The last line of standard output is one JSON object: `correct`,
`attempted` (scans in the window), `failed` (numbers over their limit),
`metrics` (the cell's end-to-end metrics, or with `--trace 1` its
per-layer metrics), `device`, with `--trace 1` `breakdown`, and last
`checked`, each compared number with its limit.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

T_START = time.perf_counter()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "lis_slam_tpu")


def steady():
    """One busy thread: torch's and the math libraries' CPU pools at one
    thread, so that a run's host work does not spread over the cores the
    card's driver and other processes use. The process is not pinned to a
    core: two runs on one machine would meet on the same one."""
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    os.environ.setdefault("MKL_NUM_THREADS", "1")
    os.environ.setdefault("OPENBLAS_NUM_THREADS", "1")


def _caches():
    """Every compiler cache at a fixed path inside the checkout."""
    cache = os.path.join(ROOT, ".bench_cache")
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = os.path.join(cache, sub)
    os.environ["USE_FLAX"] = "0"


def _fail(msg: str, code: int = 2):
    print(f"perfbench: {msg}", file=sys.stderr)
    sys.exit(code)


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def device_check(torch, chips: int):
    if not torch.cuda.is_available():
        _fail("no CUDA device: this benchmark measures the card")
    if torch.cuda.device_count() < chips:
        _fail(f"the cell asks for {chips} cards, "
              f"{torch.cuda.device_count()} present")


def loaded_forbidden() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def prepare(cell, seed: int, device, checks: dict | None = None):
    """Set-up short of the warm-up: the program's configuration, the
    traffic, the probes (with what the cell's `checks` capture) and the
    session driver."""
    from perfbench.harness import probes as P
    from perfbench.harness import program, traffic

    cfg = program.build_config(cell.config)
    tr = traffic.generate(cell.traffic, seed, device,
                          extrinsic_rot=cfg.imu.extrinsic_rot)
    probes = P.Probes().install(checks)
    sessions = program.sessions_for(cell.traffic["session"])(
        cfg, cell.config, tr, device, probes)
    sample = traffic.sample_indices(len(tr.scans),
                                    int(cell.traffic.get("sample", 12)), seed)
    return cfg, tr, probes, sessions, sample


def measure(cell, args, device, torch, checks: dict):
    """Set-up, warm-up and the window; returns what the result reads."""
    cuda = device.type == "cuda"
    cfg, tr, probes, sessions, sample = prepare(cell, args.seed, device,
                                                checks)
    probes.sample = set(sample)
    t_warm = time.perf_counter()
    # warm-up: every shape of the traffic, every stage, the probes' copies
    sessions.run()
    warm_s = time.perf_counter() - t_warm
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - T_START
    cpu = os.times()
    print(f"perfbench: set-up {setup_s:.3f} s, the warm-up session "
          f"{warm_s:.3f} s, user / system CPU {cpu.user:.2f} / "
          f"{cpu.system:.2f} s", file=sys.stderr)
    from perfbench.harness.window import run_window

    rec = run_window(sessions, probes, args.seconds, bool(args.trace),
                     sample, warm_s)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    return cfg, tr, probes, rec, setup_s, peak


def end_to_end(cell, rec, setup_s) -> dict:
    from perfbench.harness import stats

    values = {"scans_per_s": lambda: stats.rate(rec.scans, rec.window_s),
              "scan_ms_p95": lambda: 1e3 * stats.percentile(rec.latencies_s,
                                                            95),
              "setup_s": lambda: setup_s}
    return {m["name"]: {"value": values[m["name"]](), "unit": m["unit"]}
            for m in cell.end_to_end}


def per_layer(cell, rec) -> dict:
    from perfbench.harness.spec import metric_reader

    out = {}
    for m in cell.per_layer:
        v = metric_reader(m["name"])(rec)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def main(argv=None, cell=None, device=None) -> int:
    """One run. `cell` and `device` are for the harness's own tests, which
    drive a run on the CPU without the look for a card."""
    args = parse(argv)
    _caches()
    from perfbench.harness import spec

    steady()
    if cell is None:
        cell = spec.load_cell(args.workload)
    try:
        checks = spec.checks_for(cell.limits)
    except ValueError as e:
        _fail(f"{cell.name}: {e}")
    import torch

    if device is None:
        torch.set_num_threads(1)
        device_check(torch, cell.chips)
        device = torch.device("cuda", 0)
    cfg, tr, probes, rec, setup_s, peak = measure(cell, args, device, torch,
                                                  checks)
    probes.uninstall()

    from perfbench.harness import judge

    prob = judge.problem_of(rec.judged or rec.last, cfg, tr,
                            cell.traffic["session"] == "lio_odometry")
    captured = (rec.judged or rec.last).checks  # what the checks kept
    metrics = (per_layer(cell, rec) if args.trace
               else end_to_end(cell, rec, setup_s))
    device_info = {"platform": "gpu" if device.type == "cuda" else "cpu",
                   "kind": (torch.cuda.get_device_name(0)
                            if device.type == "cuda" else "cpu"),
                   "count": cell.chips, "memory_peak_bytes": int(peak)}
    breakdown = None
    attempted = rec.scans
    drains = rec.stage_s.get("drain", [0, 0.0])[0]
    print("perfbench: sessions of the window, wall / user CPU / system "
          "CPU s / median scan ms: " + " ".join(
              f"{t:.3f}/{c[0]:.2f}/{c[1]:.2f}/{m:.1f}" for t, c, m in
              zip(rec.session_s, rec.session_cpu_s, rec.session_p50_ms))
          + f"; {rec.scans} scans, {drains} drains", file=sys.stderr)
    if args.trace:
        if not rec.trace.busy_s > 0:
            _fail("the profiler saw no operation on the device", 3)
        device_info["busy_s"] = rec.trace.busy_s
        device_info["window_s"] = rec.trace.window_s
        breakdown = {"device_ops": rec.trace.device_ops,
                     "idle_gaps": rec.trace.idle_gaps}
    del rec
    if device.type == "cuda":
        torch.cuda.empty_cache()

    numbers = judge.readings(prob)
    for name, check in checks.items():
        numbers.update(check.readings(captured.get(name, []), cell.config,
                                      tr, device))
    del tr, captured
    correct, rows = judge.verdict(numbers, cell.limits)
    context = {k: v for k, v in numbers.items() if k not in cell.limits}
    if context:  # printed, not compared
        print("perfbench: other readings of the judged session: "
              + ", ".join(f"{k} {v!r}" for k, v in sorted(context.items())),
              file=sys.stderr)
    bad = loaded_forbidden()
    if bad:
        _fail(f"modules of the JAX package loaded in this process: {bad}", 3)
    result = {"correct": correct, "attempted": attempted,
              "failed": sum(1 for _n, v, lim in rows if not v <= lim),
              "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    # a number the reference could not form (a missing answer) is null
    result["checked"] = {n: {"value": v if math.isfinite(v) else None,
                             "limit": lim} for n, v, lim in rows}
    for n, v, lim in rows:
        print(f"check {n} = {v!r} (limit {lim!r})", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
