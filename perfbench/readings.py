"""The readings that the limits of `correct` are set from, many seeds in one
process (the benchmark's own runs do not run this).

    python3 perfbench/readings.py --workload <name> --seeds 1,2,3 \
        [--out FILE]

For each seed: the cell's traffic, one warm-up session (the first seed
only), then one session measured as a run's last session is, and three
readings of every number harness/judge.py forms:

- `program`: the program's answers (the lower reading of a limit is the
  largest over the seeds);
- `control`: the references one precision below the stated one, put in
  the program's place (the upper reading is the smallest).

One JSON line per seed on standard output (and appended to `--out`).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from perfbench import run  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    run.steady()
    run._caches()
    from perfbench.harness import judge
    from perfbench.harness.spec import load_cell

    cell = load_cell(args.workload)
    import torch

    torch.set_num_threads(1)
    run.device_check(torch, cell.chips)
    device = torch.device("cuda", 0)
    lio = cell.traffic["session"] == "lio_odometry"
    warm = True
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        cfg, tr, probes, sessions, sample = run.prepare(cell, seed, device)
        probes.sample = set(sample)
        if warm:
            sessions.run()
            warm = False
        line = {"workload": cell.name, "seed": seed}
        s = sessions.run()
        prob = judge.problem_of(s, cfg, tr, lio)
        line["program"] = judge.readings(prob)
        ctl = judge.control_answers(prob)
        line["control"] = judge.readings(prob, ctl)
        ref = judge.odom_answers(prob, judge.Numerics("float64"))
        line["odom_per_scan"] = {
            str(k): [judge.pose_gap(prob.got[k], ref[k]),
                     judge.pose_gap(ctl["odom"][k], ref[k])] for k in ref}
        line["scans_per_s"] = s.scans / s.wall_s
        if s.back_end is not None:
            line["n_submaps"] = s.back_end["n_submaps"]
            line["n_loops"] = s.back_end["n_loops"]
        probes.uninstall()
        line["seconds"] = time.perf_counter() - t0
        text = json.dumps(line)
        print(text, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(text + "\n")
    bad = run.loaded_forbidden()
    if bad:
        run._fail(f"modules of the JAX package loaded: {bad}", 3)
    return 0


if __name__ == "__main__":
    sys.exit(main())
