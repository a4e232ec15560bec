"""Accuracy bars of the JAX package for the VLP-16 + IMU sequence that
chip_smoke.py's lio phase runs through the PyTorch port.

The sequence: make_world(seed=5), circular_trajectory(61, radius=60,
speed=8), 60 motion-distorted 16 x 1800 sweeps from the numpy renderer with
the VLP-16 fan (np.linspace(15, -15, 16), as tests/test_lio.py patches it),
24 IMU samples per window over 0.11 s, pre-rotated by extrinsic_rot^T so
imu_to_lidar recovers the lidar frame. lio_config() with the GN backend
of --gn-backend: "xla" by default, because on the CPU the JAX package's
"pallas" GN backend runs its kernel in Pallas interpret mode, which returns
NaN poses from the second scan on for this configuration. Three runs:

  lio       LioOdometry.process_scan (gyro + positional deskew, IMU guess)
  velocity  odom_step with deskew_mode="velocity", body velocity and rate
            from ground truth (tests/test_lio.py:181-185)
  none      odom_step with use_imu=False (no deskew)

Prints one JSON line with ATE (unaligned), RPE-t and RPE-r per run.

    python scripts/lio_accuracy_bars.py [--scans 60]
        [--modes lio,velocity,none] [--gn-backend xla]
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

from scipy.spatial.transform import Rotation  # noqa: E402

import lis_slam_tpu.io.synthetic as syn  # noqa: E402
from lis_slam_tpu.config import lio_config  # noqa: E402
from lis_slam_tpu.pipeline import (  # noqa: E402
    driver, lio, odometry, trajectory)

VLP16 = np.linspace(15.0, -15.0, 16)


def render(n: int):
    syn.hdl64_elevations = lambda: VLP16
    world = syn.make_world(seed=5)
    gt = syn.circular_trajectory(n + 1, radius=60.0, speed=8.0)
    scans = [syn.render_scan(world, gt[i], gt[i + 1], n_scan=16,
                             horizon=1800, seed=500 + i) for i in range(n)]
    return scans, gt


def run(mode: str, scans, gt, base):
    n = len(scans)
    R_ext = np.asarray(base.imu.extrinsic_rot, np.float64)
    poses, resets = [], None
    t0 = time.perf_counter()
    if mode == "lio":
        system = lio.LioOdometry(base)
        for i, s in enumerate(scans):
            pose = system.process_scan(
                s.points[s.valid], imu_time=s.imu_time + i * 0.1,
                imu_gyro=(s.gyro @ R_ext).astype(np.float32),
                imu_accel=(s.accel @ R_ext).astype(np.float32),
                scan_start=i * 0.1)
            poses.append(np.asarray(pose))
        resets = system.diag.n_resets
    else:
        imu = (dict(use_imu=False, deskew_mode="velocity")
               if mode == "velocity" else dict(use_imu=False))
        cfg = base.replace(imu=dataclasses.replace(base.imu, **imu))
        state = odometry.init_state(cfg)
        for i, s in enumerate(scans):
            kw = {}
            if mode == "velocity":
                R0 = Rotation.from_euler("xyz", gt[i][:3]).as_matrix()
                kw = dict(velocity=R0.T @ (gt[i + 1][3:] - gt[i][3:]) / 0.1,
                          angular_rate=s.gyro[0])
            state, out = odometry.odom_step(
                state, driver.pad_scan(s.points[s.valid], cfg, **kw), cfg)
            poses.append(np.asarray(out.pose))
    wall = time.perf_counter() - t0
    poses = np.asarray(poses)
    gt_rel = trajectory.relative_to_first(gt[:n])
    rpe_t, rpe_r = trajectory.rpe(poses, gt_rel)
    return dict(ate_m=float(trajectory.ate_rmse(poses, gt_rel, align=False)),
                rpe_t_m=float(rpe_t), rpe_r_deg=float(rpe_r),
                imu_resets=resets, wall_s=wall,
                finite=bool(np.isfinite(poses).all()))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scans", type=int, default=60)
    ap.add_argument("--modes", default="lio,velocity,none")
    ap.add_argument("--gn-backend", default="xla")
    args = ap.parse_args()
    base = lio_config()
    base = base.replace(matching=dataclasses.replace(
        base.matching, gn_backend=args.gn_backend))
    scans, gt = render(args.scans)
    out = {"scans": args.scans, "platform": jax.default_backend(),
           "gn_backend": args.gn_backend}
    for mode in args.modes.split(","):
        out[mode] = run(mode, scans, gt, base)
        print(mode, json.dumps(out[mode]), flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
