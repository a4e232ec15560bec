"""The one traffic generator: a traffic file's parameters and `--seed` in,
the scans of one session out.

Parameters (perfbench/traffic/<name>.json):

- `session`: the entry the window drives, the driver
  `perfbench/sessions/<session>.py` (`semantic_slam`, `lio_odometry`,
  `replay_batched`);
- `lanes`: sequences replayed side by side (`replay_batched`), each
  rendered with noise from its own seed; 1 otherwise;
- `world` and `world_seed`: the fixed geometry, built by
  `perfbench/worlds/<world>.py`;
- `beams` (`hdl64`, `vlp16`) and `horizon`: the sensor's fan;
- `radius` and `lap_scans` (speed so that the lap closes) or `speed`:
  the circular drive, one scan every 0.1 s;
- `renders`: the lengths of consecutive noise renders, each from the
  start of the drive with noise from its own seed derived from `--seed`
  (the plaza lap: 100 scans, then a 40-scan revisit that closes loops);
- `distorted`: each sweep moves from its pose to the next over its 0.1 s;
  `imu`: the sweep's IMU rows (24 samples over 0.11 s), in the IMU frame;
- `labels`: `gt` hands the renderer's per-point classes to the program,
  `none` hands none;
- `drift_per_scan`: rad of yaw about the origin injected per scan
  (SemanticSlam's pose_hook), 0 for none;
- `sample`: how many answers of the last finished session the check
  compares.

Every seed gives the same geometry, scan count and sizes; only the
sensor noise differs.
"""

from __future__ import annotations

import importlib
from dataclasses import dataclass

import numpy as np
import torch

from . import render


@dataclass
class Scan:
    points: np.ndarray  # (n, 4) float32 xyzi, the sensor's valid returns
    labels: np.ndarray | None  # (n,) int32 learning classes
    # (time (m,), gyro (m,3), accel (m,3)), IMU frame, float32 as a
    # driver hands them over
    imu: tuple | None
    start: float  # the sweep's start stamp, s (a float32 value)


@dataclass
class Traffic:
    scans: list  # the first lane's
    gt: np.ndarray  # (n, 6) true poses
    params: dict
    lanes: list | None = None  # every lane's scans, where there are lanes


def derived_seed(seed: int, k: int) -> int:
    """The k-th 63-bit seed derived from a run's seed."""
    ss = np.random.SeedSequence([int(seed) & ((1 << 64) - 1), k])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def generate(params: dict, seed: int, device, extrinsic_rot=None) -> Traffic:
    """Render one session's scans on `device` and hand them over as host
    arrays. `extrinsic_rot` (3x3, the configuration's IMU mounting) turns
    the lidar-frame IMU rows into the IMU's own frame."""
    n_lanes = int(params.get("lanes", 1))
    lanes = [_lane(params, seed, device, extrinsic_rot, 100 * k)
             for k in range(n_lanes)]
    scans, gt = lanes[0]
    return Traffic(scans=scans, gt=gt, params=params,
                   lanes=[s for s, _g in lanes] if n_lanes > 1 else None)


def _lane(params: dict, seed: int, device, extrinsic_rot, base: int):
    """One lane's scans and true poses; its renders' noise from the seeds
    derived from (seed, base + render)."""
    world = render.to_device_world(
        importlib.import_module(f"perfbench.worlds.{params['world']}")
        .build(int(params.get("world_seed", 0))), device)
    radius = float(params["radius"])
    speed = (render.lap_speed(radius, params["lap_scans"])
             if "lap_scans" in params else float(params["speed"]))
    renders = [int(n) for n in params["renders"]]
    gt_drive = render.circular_trajectory(max(renders) + 1, radius=radius,
                                          speed=speed)
    elev = render.ELEVATIONS[params["beams"]]()
    distorted = bool(params.get("distorted", False))
    want_imu = bool(params.get("imu", False))
    want_labels = params.get("labels", "none") == "gt"
    R_ext = (np.eye(3) if extrinsic_rot is None
             else np.asarray(extrinsic_rot, np.float64))
    scans, gt = [], []
    for r, count in enumerate(renders):
        gen = torch.Generator(device=device)
        gen.manual_seed(derived_seed(seed, base + r))
        for i in range(count):
            nxt = torch.as_tensor(gt_drive[i + 1]) if distorted else None
            p, lab, v = render.render_scan_device(
                world, torch.as_tensor(gt_drive[i]), gen,
                n_scan=len(elev), horizon=int(params["horizon"]),
                next_pose6=nxt, elevations=elev)
            k = len(scans)
            imu = None
            if want_imu:
                g, a, t = render.imu_rows(gt_drive[i], gt_drive[i + 1])
                imu = ((t + k * 0.1).astype(np.float32),
                       (g @ R_ext).astype(np.float32),
                       (a @ R_ext).astype(np.float32))
            scans.append(Scan(
                points=p[v].cpu().numpy(),
                labels=lab[v].to(torch.int32).cpu().numpy()
                if want_labels else None,
                imu=imu, start=float(np.float32(k * 0.1))))
            gt.append(gt_drive[i])
    return scans, np.asarray(gt)


def sample_indices(n_scans: int, count: int, seed: int) -> list[int]:
    """The scans of a session whose answers the check compares: the
    first (the start), the last, and the rest drawn from the seed."""
    rng = np.random.default_rng(derived_seed(seed, 1000))
    rest = rng.choice(np.arange(1, n_scans - 1),
                      size=min(max(count - 2, 0), n_scans - 2),
                      replace=False)
    return sorted({0, n_scans - 1, *(int(i) for i in rest)})
