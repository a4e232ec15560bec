"""Host-side replay driver: streams scans through the odometry step (port
of lis_slam_tpu/pipeline/driver.py, no-IMU form; replaces the reference's
ROS node + rosbag-play runtime)."""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from ..config import SlamConfig
from . import odometry


@dataclass
class ReplayResult:
    poses: np.ndarray  # (N, 6)
    keyframes: np.ndarray  # (N,) bool
    n_valid: np.ndarray  # (N,)
    iterations: np.ndarray  # (N,)
    scans_per_sec: float
    wall_s: float


def pad_scan(points_xyzi: np.ndarray, cfg: SlamConfig,
             device: torch.device | str = "cpu") -> odometry.ScanInput:
    """Pad a raw (P, 4) host cloud to the fixed scan buffer
    (cfg.sensor.max_raw_points rows) on `device`."""
    p = cfg.sensor.max_raw_points
    pts = np.zeros((p, 4), np.float32)
    n = min(len(points_xyzi), p)
    pts[:n] = points_xyzi[:n]
    return odometry.ScanInput(
        points=torch.from_numpy(pts).to(device),
        valid=torch.arange(p, device=device) < n)


def compact_scan(points: torch.Tensor, valid: torch.Tensor, cfg: SlamConfig,
                 capacity: int | None = None) -> odometry.ScanInput:
    """The benchmark's data-loader step (bench.py `prep`), on the points'
    device: drop the rings that cfg.sensor.downsample_rate discards anyway
    and pack the rest to the front of a `capacity`-row buffer (default
    cfg.sensor.max_raw_points). points (P, 4) xyzi, valid (P,)."""
    from ..ops import pretreatment

    cap = cfg.sensor.max_raw_points if capacity is None else capacity
    dev = points.device
    ring, ok = pretreatment.compute_ring(points, valid, cfg.sensor.n_scan)
    keep = ok & (ring % cfg.sensor.downsample_rate == 0)
    pos = torch.cumsum(keep.to(torch.int32), 0) - 1
    dest = torch.where(keep & (pos < cap), pos,
                       torch.full_like(pos, cap)).to(torch.int64)
    buf = torch.zeros((cap + 1, 4), dtype=torch.float32, device=dev)
    buf[dest] = points.to(torch.float32)
    cnt = torch.clamp(torch.sum(keep.to(torch.int32)), max=cap)
    return odometry.ScanInput(points=buf[:cap],
                              valid=torch.arange(cap, device=dev) < cnt)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def replay_odometry(scans, cfg: SlamConfig, warmup: int = 0,
                    device: torch.device | str = "cpu") -> ReplayResult:
    """Run the front-end odometry over an iterable of scans: each an
    odometry.ScanInput already padded on `device`, a SyntheticScan-like
    host object (``.points``, ``.valid``) or a raw (P, 4) numpy array.
    Scans/s counts the scans after the first `warmup`, timed from a device
    sync to a device sync."""
    device = torch.device(device)
    state = odometry.init_state(cfg, device)
    poses, kfs, nvs, its = [], [], [], []
    t0 = None
    for i, scan in enumerate(scans):
        if not isinstance(scan, odometry.ScanInput):
            arr = (scan.points[scan.valid] if hasattr(scan, "points")
                   else np.asarray(scan))
            scan = pad_scan(arr, cfg, device)
        state, out = odometry.odom_step(state, scan, cfg)
        if i + 1 == warmup:
            _sync(device)
            t0 = time.perf_counter()
        poses.append(out.pose)
        kfs.append(out.is_keyframe)
        nvs.append(out.n_valid)
        its.append(out.iterations)
    _sync(device)
    wall = time.perf_counter() - t0 if t0 is not None else 0.0
    n_timed = len(poses) - warmup if t0 is not None else 0
    return ReplayResult(
        poses=torch.stack(poses).cpu().numpy() if poses else np.zeros((0, 6)),
        keyframes=np.asarray(kfs),
        n_valid=np.asarray(nvs),
        iterations=np.asarray(its),
        scans_per_sec=(n_timed / wall) if n_timed and wall > 0 else 0.0,
        wall_s=wall,
    )
