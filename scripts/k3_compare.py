#!/usr/bin/env python3
"""Time kernel K3 (lis_slam_torch/csrc/gn_solve.cu) of this checkout
against K3 of other checkouts on one NVIDIA GPU, in turns, on the seeded
synthetic lanes of tests/test_torch_kernels_cuda.py (well conditioned,
degenerate, frozen, too few rows, an eigenvalue at the degeneracy
threshold).

Each other checkout is a directory holding a `lis_slam_torch` package
(the parent commit unpacked with `git archive`, or a copy of the package
with the kernel edited), loaded as chip_smoke.py's --baseline is. For
each, the script prints its K3's `-Xptxas -v` lines, whether its flags
and `it` equal this checkout's plain version (pose and projector errors
beside), and device ms per launch (torch.profiler, as chip_smoke.py
counts it) at B = 1, 8 and 32, every checkout twice, in the order
a, b, ..., b, a.

    python3 scripts/k3_compare.py [DIR ...]
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("others", nargs="*", help="checkouts to time beside "
                    "this one")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from lis_slam_torch.config import SlamConfig
    from lis_slam_torch.ops import cuda_build, gn_solve
    from test_torch_kernels_cuda import _k3_lanes

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip())
    gn_solve._lib()
    mods = {"this": (gn_solve, cs._ptxas_usage(
        cuda_build.build_log("gn_solve", gn_solve._FLAGS)))}
    for k, d in enumerate(args.others):
        base = cs._load_baseline(d, name=f"k3_other{k}")
        mods[d] = (base.gn_solve, base.usage)
    for name, (_g, usage) in mods.items():
        print(f"{name}: ptxas {usage}")
    cfg = SlamConfig().matching
    for lanes in (1, 8, 32):
        hg, pose0, kinds = _k3_lanes(lanes)
        hg = torch.from_numpy(hg).cuda()
        st = gn_solve.init_state(torch.from_numpy(pose0).cuda())
        st = st._replace(converged=torch.from_numpy(kinds == 2).cuda())
        ref, _ = gn_solve.solve_plain(hg, st, cfg)
        times = {n: [] for n in mods}
        for name in list(mods) + list(mods)[::-1]:
            g = mods[name][0]
            times[name].append(cs.device_ms(lambda: g.solve(hg, st, cfg),
                                            iters=50)[0])
        for name, (g, _u) in mods.items():
            new, _ = g.solve(hg, st, cfg)
            torch.cuda.synchronize()
            flags = all(torch.equal(getattr(new, f), getattr(ref, f))
                        for f in ("degenerate", "converged", "n_valid", "it"))
            print(f"B{lanes} {name}: device ms "
                  f"{', '.join(f'{t:.5f}' for t in times[name])}; flags "
                  f"and it equal to the plain version {flags}, pose err "
                  f"{float((new.pose - ref.pose).abs().max()):.3g}, proj err "
                  f"{float((new.proj - ref.proj).abs().max()):.3g}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
