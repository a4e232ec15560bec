"""Accuracy bars of the JAX package for the KITTI-replay run that
chip_smoke.py's cli phase makes through the PyTorch port's CLI
(python -m lis_slam_torch.run_kitti).

The sequence is the plaza lap of scripts/full_slam_accuracy_bars.py (the
JAX bench's full-SLAM section, bench.py:123-258): the plaza world, the
exactly periodic lap circular_trajectory(101, radius=10, speed=2*pi*10 /
(100 * 0.1)), 100 scans and then 40 more along the start of the lap on a
second noise render (numpy renderer, seeds 900 + i and 1900 + i), HDL-64
at 64 x 1800. As the CLI sees it: the valid points of each sweep as the
KITTI .bin holds them, range-gated as the native loader gates them
(lidar_min_range, lidar_max_range), padded to the kitti preset's
max_raw_points (150000), no labels, no drift hook, the default
timestamps. SemanticSlam with PRESETS["kitti"]() and the GN backend of
--gn-backend ("xla" by default: on the CPU the "pallas" backend runs its
kernel in Pallas interpret mode).

Prints the corrected and raw ATE (aligned, as the CLI computes it), RPE,
submaps, loop factors and keyframes as one JSON line.

    python scripts/cli_accuracy_bars.py [--lap 100] [--extra 40]
        [--gn-backend xla]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import lis_slam_tpu.io.synthetic as syn  # noqa: E402
from lis_slam_tpu.config import PRESETS  # noqa: E402
from lis_slam_tpu.pipeline import driver, slam, trajectory  # noqa: E402
# the plaza world, numpy only (shared with chip_smoke.py's phases)
from lis_slam_torch.io.synthetic_torch import plaza_world  # noqa: E402


def range_gate(pts: np.ndarray, lo: float, hi: float) -> np.ndarray:
    """The native loader's range gate (native/lis_host.cpp
    lis_range_filter) in float32: finite, lo^2 <= r^2 <= hi^2, r^2 > 1e-6."""
    x, y, z = (pts[:, i] for i in range(3))
    r2 = x * x + y * y + z * z
    keep = (np.isfinite(pts[:, :3]).all(1) & (r2 >= np.float32(lo * lo))
            & (r2 <= np.float32(hi * hi)) & (r2 > np.float32(1e-6)))
    return pts[keep]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--lap", type=int, default=100)
    ap.add_argument("--extra", type=int, default=40)
    ap.add_argument("--gn-backend", default="xla")
    args = ap.parse_args()
    base = PRESETS["kitti"]()
    cfg = base.replace(matching=dataclasses.replace(
        base.matching, gn_backend=args.gn_backend))
    world = plaza_world()
    n = args.lap
    gt = syn.circular_trajectory(n + 1, radius=10.0,
                                 speed=2.0 * np.pi * 10.0 / (n * 0.1))
    lo, hi = cfg.sensor.lidar_min_range, cfg.sensor.lidar_max_range
    t0 = time.perf_counter()
    clouds = []
    for seed0, count in ((900, n), (1900, args.extra)):
        for i in range(count):
            s = syn.render_scan(world, gt[i], seed=seed0 + i)
            clouds.append(range_gate(
                s.points[s.valid].astype(np.float32), lo, hi))
    t_render = time.perf_counter() - t0
    gt_replay = trajectory.relative_to_first(
        np.concatenate([gt[:n], gt[:args.extra]]))

    t0 = time.perf_counter()
    system = slam.SemanticSlam(cfg)
    for pts in clouds:
        system.process_scan(driver.pad_scan(pts, cfg))
    res = system.finish()
    wall = time.perf_counter() - t0
    rpe_t, rpe_r = trajectory.rpe(res.poses, gt_replay)
    out = dict(
        scans=len(clouds), platform=jax.default_backend(),
        gn_backend=args.gn_backend,
        points_per_scan=int(np.mean([len(c) for c in clouds])),
        ate_corrected_m=trajectory.ate_rmse(res.poses, gt_replay, align=True),
        ate_raw_m=trajectory.ate_rmse(res.raw_poses, gt_replay, align=True),
        rpe_t_m=float(rpe_t), rpe_r_deg=float(rpe_r),
        n_submaps=int(res.n_submaps), loop_factors=int(res.n_loops),
        keyframes=len(system.keyframes),
        finite=bool(np.isfinite(res.poses).all()),
        render_s=t_render, wall_s=wall)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
