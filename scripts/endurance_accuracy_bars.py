"""Accuracy bars of the JAX package for the endurance sequence that
chip_smoke.py's endurance phase runs through the PyTorch port.

The sequence is the JAX bench's endurance section (bench.py:274-400): the
plaza lap of scripts/full_slam_accuracy_bars.py (rng seed 9 world, the
exactly periodic lap circular_trajectory(101, radius=10, speed=2*pi*10 /
(100 * 0.1)), HDL-64 scans from the numpy renderer compacted to P =
65536, ground-truth labels), tiled --laps times. Even laps replay render
A (seeds 900 + i), odd laps render B (seeds 1900 + i), so revisits never
see identical scans; timestamp = k * 0.1 and the drift hook th = 3e-4 * k
take the global scan index k. SlamConfig() at full width, with the GN
backend of --gn-backend ("xla" by default: on the CPU the "pallas"
backend runs its kernel in Pallas interpret mode).

Prints one JSON line: the corrected and raw ATE (aligned, bench.py:
384-387), per-lap ATE of the globally aligned corrected trajectory
(bench.py:388-396), loop factors, submaps, keyframes and keyframes
released, the pose graph's nodes and edges, and each lap's wall seconds.
Per-lap progress goes to stderr.

    python scripts/endurance_accuracy_bars.py [--laps 10] [--lap 100]
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

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

# the full-SLAM bar script's world, loader and drift hook (it also puts
# the repo root on sys.path and pins JAX to the CPU)
from full_slam_accuracy_bars import P, compact, drift_hook  # noqa: E402

import jax  # noqa: E402

import lis_slam_tpu.io.synthetic as syn  # noqa: E402
from lis_slam_tpu.config import SensorConfig, SlamConfig  # noqa: E402
from lis_slam_tpu.pipeline import slam, trajectory  # noqa: E402
from lis_slam_torch.io.synthetic_torch import plaza_world  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--laps", type=int, default=10)
    ap.add_argument("--lap", type=int, default=100)
    ap.add_argument("--gn-backend", default="xla")
    args = ap.parse_args()
    base = SlamConfig().replace(sensor=SensorConfig(max_raw_points=P))
    cfg = base.replace(matching=dataclasses.replace(
        base.matching, gn_backend=args.gn_backend))
    world = plaza_world()
    n = args.lap
    gt = syn.circular_trajectory(n + 1, radius=10.0,
                                 speed=2.0 * np.pi * 10.0 / (n * 0.1))
    t0 = time.perf_counter()
    renders = [[compact(syn.render_scan(world, gt[i], seed=seed + i), cfg)
                for i in range(n)] for seed in (900, 1900)]
    t_render = time.perf_counter() - t0
    print(f"rendered {2 * n} scans in {t_render:.1f} s", file=sys.stderr,
          flush=True)

    system = slam.SemanticSlam(cfg, pose_hook=drift_hook)
    lap_walls = []
    t0 = t_lap = time.perf_counter()
    for k in range(args.laps * n):
        sin, lab = renders[(k // n) % 2][k % n]
        system.process_scan(sin, gt_labels=lab, timestamp=k * 0.1)
        if (k + 1) % n == 0:
            now = time.perf_counter()
            lap_walls.append(now - t_lap)
            t_lap = now
            print(f"lap {len(lap_walls)}: {lap_walls[-1]:.1f} s, "
                  f"{len(system.keyframes)} keyframes, "
                  f"{len(system.graph.nodes)} nodes, "
                  f"{len(system.graph.edges)} edges", file=sys.stderr,
                  flush=True)
    system.flush_pipeline()
    res = system.finish()
    wall = time.perf_counter() - t0
    gt_tiled = np.tile(trajectory.relative_to_first(gt[:n]), (args.laps, 1))
    e = res.poses[:, 3:6].astype(np.float64)
    g = gt_tiled[:, 3:6].astype(np.float64)
    R, t = trajectory.align_umeyama(e, g)
    per_lap = np.sqrt(np.mean(np.sum((e @ R.T + t - g) ** 2, axis=1)
                              .reshape(args.laps, n), axis=1))
    out = dict(
        laps=args.laps, scans=args.laps * n, platform=jax.default_backend(),
        gn_backend=args.gn_backend,
        ate_corrected_m=trajectory.ate_rmse(res.poses, gt_tiled, align=True),
        ate_raw_m=trajectory.ate_rmse(res.raw_poses, gt_tiled, align=True),
        lap_ate_m=[float(x) for x in per_lap],
        n_submaps=int(res.n_submaps), loop_factors=int(res.n_loops),
        keyframes=len(system.keyframes),
        keyframes_released=sum(1 for kf in system.keyframes if kf.released),
        graph_nodes=len(system.graph.nodes),
        graph_edges=len(system.graph.edges),
        finite=bool(np.isfinite(res.poses).all()),
        lap_wall_s=lap_walls, render_s=t_render, wall_s=wall)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
