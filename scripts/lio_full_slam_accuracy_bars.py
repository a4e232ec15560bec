"""Accuracy bars of the JAX package for the LiDAR-inertial full-SLAM runs
that chip_smoke.py's lio_slam phase drives through the PyTorch port.

The sequence is the slam phase's (scripts/full_slam_accuracy_bars.py): the
plaza world, the exactly periodic lap circular_trajectory(101, radius=10,
speed=2*pi*10 / (100 * 0.1)), 100 HDL-64 scans and 40 more along the start
of the lap on a second noise render (numpy renderer, seeds 900 + i and
1900 + i), ground-truth labels, compacted to P = 65536 as the bench's loader
does, default SlamConfig with the GN backend of --gn-backend ("xla" by
default: on the CPU the "pallas" backend runs its kernel in Pallas
interpret mode, which returns NaN poses on the LIO path). No pose_hook.
Modes:

  lio       the JAX bench's lio_full_slam mode (bench.py:415-466):
            use_imu=True, constant IMU windows of 12 samples at 0.01 s with
            the lap's yaw rate w = v / 10 and specific force (0, v w, g),
            pre-rotated by extrinsic_rot^T; the first scan without a
            timestamp (its clock is imu_time[0] = 0), then i * 0.1
  none      the same scans with use_imu=False
  dist_lio  motion-distorted sweeps (each rendered moving from gt[i] to
            gt[i + 1]) with the renderer's own IMU rows (24 samples over
            0.11 s), pre-rotated by extrinsic_rot^T, use_imu=True
  dist_none the distorted sweeps with use_imu=False

Prints one JSON line per mode: corrected and raw ATE (aligned, as
bench.py:245-248), RPE, IMU resets, submaps, loop factors, keyframes.

    python scripts/lio_full_slam_accuracy_bars.py [--modes lio,none]
        [--lap 100] [--extra 40] [--gn-backend xla]
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
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from full_slam_accuracy_bars import P, compact  # noqa: E402  (sets jax to cpu)

import jax  # noqa: E402

import lis_slam_tpu.io.synthetic as syn  # noqa: E402
from lis_slam_tpu.config import SensorConfig, SlamConfig  # noqa: E402
from lis_slam_tpu.pipeline import slam, trajectory  # noqa: E402
from lis_slam_torch.io.synthetic_torch import plaza_world  # noqa: E402

MODES = ("lio", "none", "dist_lio", "dist_none")


def bench_imu(cfg: SlamConfig, speed: float):
    """bench.py:435-443: 12 constant samples, IMU frame."""
    omega = speed / 10.0
    R_ext = np.asarray(cfg.imu.extrinsic_rot, np.float64)
    g_l = np.array([0.0, 0.0, omega])
    a_l = np.array([0.0, speed * omega, cfg.imu.gravity])
    gyro = np.tile((R_ext.T @ g_l)[None, :], (12, 1)).astype(np.float32)
    accel = np.tile((R_ext.T @ a_l)[None, :], (12, 1)).astype(np.float32)
    return np.arange(12, dtype=np.float32) * 0.01, gyro, accel


def run(cfg: SlamConfig, seq, imu):
    """seq: [(ScanInput, labels)]; imu: None or [(time, gyro, accel)] per
    scan (absolute seconds)."""
    system = slam.SemanticSlam(cfg)
    for i, (sin, lab) in enumerate(seq):
        kw = {}
        if imu is not None:
            it, ig, ia = imu[i]
            kw = dict(imu_time=it, imu_gyro=ig, imu_accel=ia)
        # the bench's first scan carries no timestamp (t = imu_time[0])
        ts = None if (i == 0 and imu is not None) else i * 0.1
        system.process_scan(sin, gt_labels=lab, timestamp=ts, **kw)
    system.flush_pipeline()
    return system, system.finish()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--modes", default="lio,none")
    ap.add_argument("--lap", type=int, default=100)
    ap.add_argument("--extra", type=int, default=40)
    ap.add_argument("--gn-backend", default="xla")
    args = ap.parse_args()
    modes = args.modes.split(",")
    assert set(modes) <= set(MODES), modes
    base = SlamConfig().replace(sensor=SensorConfig(max_raw_points=P))
    cfg = base.replace(matching=dataclasses.replace(
        base.matching, gn_backend=args.gn_backend))
    cfg_imu = cfg.replace(imu=dataclasses.replace(cfg.imu, use_imu=True))
    world = plaza_world()
    n = args.lap
    speed = 2.0 * np.pi * 10.0 / (n * 0.1)
    gt = syn.circular_trajectory(n + 1, radius=10.0, speed=speed)
    poses = [gt[i] for i in range(n)] + [gt[i] for i in range(args.extra)]
    nxt = [gt[i + 1] for i in range(n)] + [gt[i + 1]
                                           for i in range(args.extra)]
    seeds = ([900 + i for i in range(n)]
             + [1900 + i for i in range(args.extra)])
    gt_rel = trajectory.relative_to_first(np.asarray(poses))
    R_ext = np.asarray(cfg.imu.extrinsic_rot, np.float64)
    seqs = {}
    for mode in modes:
        distorted = mode.startswith("dist")
        if distorted in seqs:
            continue
        t0 = time.perf_counter()
        scans = [syn.render_scan(world, p, q if distorted else None, seed=s)
                 for p, q, s in zip(poses, nxt, seeds)]
        seq = [compact(s, cfg) for s in scans]
        if distorted:
            imu = [(s.imu_time + i * 0.1,
                    (s.gyro @ R_ext).astype(np.float32),
                    (s.accel @ R_ext).astype(np.float32))
                   for i, s in enumerate(scans)]
        else:
            it, ig, ia = bench_imu(cfg, speed)
            imu = [(it + i * 0.1, ig, ia) for i in range(len(seq))]
        seqs[distorted] = (seq, imu, time.perf_counter() - t0)
    for mode in modes:
        seq, imu, t_render = seqs[mode.startswith("dist")]
        use_imu = mode.endswith("lio")
        t0 = time.perf_counter()
        system, res = run(cfg_imu if use_imu else cfg, seq,
                          imu if use_imu else None)
        wall = time.perf_counter() - t0
        rpe_t, rpe_r = trajectory.rpe(res.poses, gt_rel)
        print(json.dumps(dict(
            mode=mode, scans=len(seq), platform=jax.default_backend(),
            gn_backend=args.gn_backend,
            ate_corrected_m=trajectory.ate_rmse(res.poses, gt_rel,
                                                align=True),
            ate_raw_m=trajectory.ate_rmse(res.raw_poses, gt_rel, align=True),
            rpe_t_m=float(rpe_t), rpe_r_deg=float(rpe_r),
            imu_resets=int(system.n_imu_resets),
            n_submaps=int(res.n_submaps), loop_factors=int(res.n_loops),
            keyframes=len(system.keyframes),
            finite=bool(np.isfinite(res.poses).all()),
            render_s=t_render, wall_s=wall)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
