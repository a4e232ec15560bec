"""Accuracy bars of the JAX package for the full-SLAM sequence with
INFERRED labels, which chip_smoke.py's slam_infer phase runs through the
PyTorch port.

The sequence is that of scripts/full_slam_accuracy_bars.py (the JAX
bench's plaza lap, 100 + 40 HDL-64 scans from the numpy renderer,
compacted to P = 65536, drift hook 3e-4 rad per scan, default SlamConfig
at full width), with its `compact` and `drift_hook`. The difference: no
ground-truth labels are passed and cfg.semantic.enabled is set, so
SemanticSlam loads the in-repo RangeNet checkpoint
(lis_slam_tpu/weights/rangenet_synthetic_slim.npz) and labels every
keyframe by inference (lab_mode "infer").

Prints the corrected and raw ATE (aligned), RPE, submaps, loop factors and
keyframes as one JSON line.

    python scripts/full_slam_infer_accuracy_bars.py [--lap 100] [--extra 40]
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

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(_HERE))
sys.path.insert(0, _HERE)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import lis_slam_tpu.io.synthetic as syn  # noqa: E402
from full_slam_accuracy_bars import P, compact, drift_hook  # noqa: E402
from lis_slam_tpu.config import (SemanticConfig, SensorConfig,  # noqa: E402
                                 SlamConfig)
from lis_slam_tpu.pipeline import slam, trajectory  # noqa: E402
from lis_slam_torch.io.synthetic_torch import plaza_world  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--lap", type=int, default=100)
    ap.add_argument("--extra", type=int, default=40)
    ap.add_argument("--gn-backend", default="xla")
    args = ap.parse_args()
    base = SlamConfig().replace(sensor=SensorConfig(max_raw_points=P),
                                semantic=SemanticConfig(enabled=True))
    cfg = base.replace(matching=dataclasses.replace(
        base.matching, gn_backend=args.gn_backend))
    world = plaza_world()
    n = args.lap
    gt = syn.circular_trajectory(n + 1, radius=10.0,
                                 speed=2.0 * np.pi * 10.0 / (n * 0.1))
    t0 = time.perf_counter()
    lap1 = [compact(syn.render_scan(world, gt[i], seed=900 + i), cfg)[0]
            for i in range(n)]
    lap2 = [compact(syn.render_scan(world, gt[i], seed=1900 + i), cfg)[0]
            for i in range(args.extra)]
    t_render = time.perf_counter() - t0
    seq = lap1 + lap2
    gt_replay = trajectory.relative_to_first(
        np.concatenate([gt[:n], gt[:args.extra]]))

    t0 = time.perf_counter()
    system = slam.SemanticSlam(cfg, pose_hook=drift_hook)
    if system.model is None:
        raise SystemExit("no RangeNet checkpoint: labels would not be "
                         "inferred")
    for i, sin in enumerate(seq):
        system.process_scan(sin, timestamp=i * 0.1)
    system.flush_pipeline()
    res = system.finish()
    wall = time.perf_counter() - t0
    rpe_t, rpe_r = trajectory.rpe(res.poses, gt_replay)
    out = dict(
        scans=len(seq), platform=jax.default_backend(),
        gn_backend=args.gn_backend, labels="inferred",
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
