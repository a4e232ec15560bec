"""Accuracy bars of the JAX package for the full-SLAM sequence that
chip_smoke.py's slam phase runs through the PyTorch port.

The sequence is the JAX bench's full-SLAM section (bench.py:123-258): the
plaza world (rng seed 9, 14 buildings on a 30 m ring, 24 poles), the
exactly periodic lap circular_trajectory(101, radius=10, speed=2*pi*10 /
(100 * 0.1)), 100 scans and then 40 more along the start of the lap on a
second noise render, ground-truth labels, and the drift hook th = 3e-4 *
idx (yaw about the world origin) applied through SemanticSlam's pose_hook.
Scans are HDL-64 (64 x 1800) from the numpy renderer (seeds 900 + i and
1900 + i), ring-downsampled and compacted to P = 65536 as the bench's
loader does. SlamConfig() at full width, with the GN backend of
--gn-backend ("xla" by default: on the CPU the "pallas" backend runs its
kernel in Pallas interpret mode).

Prints the corrected and raw ATE (aligned, as bench.py:245-248), RPE,
submaps, loop factors and keyframes as one JSON line.

    python scripts/full_slam_accuracy_bars.py [--lap 100] [--extra 40]
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

import jax.numpy as jnp  # noqa: E402

import lis_slam_tpu.io.synthetic as syn  # noqa: E402
from lis_slam_tpu.config import SensorConfig, SlamConfig  # noqa: E402
from lis_slam_tpu.ops import pretreatment  # noqa: E402
from lis_slam_tpu.pipeline import odometry, slam, trajectory  # noqa: E402
from lis_slam_tpu.utils import se3_np  # noqa: E402
# the plaza world, numpy only (shared with chip_smoke.py's slam phase)
from lis_slam_torch.io.synthetic_torch import plaza_world  # noqa: E402

P = 65536


def drift_hook(pose6, idx):
    """bench.py:216-221: a yaw error growing 3e-4 rad per scan."""
    th = 3e-4 * idx
    c, s = np.cos(th), np.sin(th)
    Td = np.eye(4)
    Td[:2, :2] = [[c, -s], [s, c]]
    return se3_np.matrix_to_pose(Td @ se3_np.pose_to_matrix(pose6))


def compact(scan: syn.SyntheticScan, cfg: SlamConfig):
    """The bench loader (bench.py:74-82): drop the rings downsample_rate
    discards and pack the rest, with their labels, into P rows."""
    ring, ok = pretreatment.compute_ring(jnp.asarray(scan.points),
                                         jnp.asarray(scan.valid),
                                         cfg.sensor.n_scan)
    keep = np.asarray(ok & (ring % cfg.sensor.downsample_rate == 0))
    pts = scan.points[keep][:P]
    buf = np.zeros((P, 4), np.float32)
    buf[:len(pts)] = pts
    sin = odometry.ScanInput(
        points=jnp.asarray(buf), valid=jnp.arange(P) < len(pts),
        imu_time=jnp.zeros(cfg.imu.max_imu_per_scan),
        imu_gyro=jnp.zeros((cfg.imu.max_imu_per_scan, 3)),
        imu_valid=jnp.zeros(cfg.imu.max_imu_per_scan, bool),
        scan_start=jnp.float32(0.0))
    return sin, scan.labels[keep][:P].astype(np.int32)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--lap", type=int, default=100)
    ap.add_argument("--extra", type=int, default=40)
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
    lap1 = [compact(syn.render_scan(world, gt[i], seed=900 + i), cfg)
            for i in range(n)]
    lap2 = [compact(syn.render_scan(world, gt[i], seed=1900 + i), cfg)
            for i in range(args.extra)]
    t_render = time.perf_counter() - t0
    n_replay = n + args.extra
    gt_replay = trajectory.relative_to_first(
        np.concatenate([gt[:n], gt[:args.extra]]))

    t0 = time.perf_counter()
    system = slam.SemanticSlam(cfg, pose_hook=drift_hook)
    for i in range(n_replay):
        sin, lab = lap1[i] if i < n else lap2[i - n]
        system.process_scan(sin, gt_labels=lab, timestamp=i * 0.1)
    system.flush_pipeline()
    res = system.finish()
    wall = time.perf_counter() - t0
    rpe_t, rpe_r = trajectory.rpe(res.poses, gt_replay)
    out = dict(
        scans=n_replay, platform=jax.default_backend(),
        gn_backend=args.gn_backend,
        ate_corrected_m=trajectory.ate_rmse(res.poses, gt_replay, align=True),
        ate_raw_m=trajectory.ate_rmse(res.raw_poses, gt_replay, align=True),
        rpe_t_m=float(rpe_t), rpe_r_deg=float(rpe_r),
        n_submaps=int(res.n_submaps), loop_factors=int(res.n_loops),
        loops_pending=len(system.loops), keyframes=len(system.keyframes),
        finite=bool(np.isfinite(res.poses).all()),
        render_s=t_render, wall_s=wall)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
