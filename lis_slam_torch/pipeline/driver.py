"""Host-side replay driver: streams scans through the odometry step (port
of lis_slam_tpu/pipeline/driver.py; replaces the reference's ROS node +
rosbag-play runtime)."""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from ..config import SlamConfig
from ..utils import device as devices
from . import odometry


@dataclass
class ReplayResult:
    poses: np.ndarray  # (N, 6)
    keyframes: np.ndarray  # (N,) bool
    n_valid: np.ndarray  # (N,)
    iterations: np.ndarray  # (N,)
    scans_per_sec: float
    wall_s: float


def pad_imu_window(cfg: SlamConfig, imu_time: np.ndarray,
                   imu_gyro: np.ndarray, imu_accel: np.ndarray | None):
    """Zero-pad an IMU window to cfg.imu.max_imu_per_scan rows (numpy).
    Accel rows that carry no measurement (the padding, and every row of a
    gyro-only window, imu_accel=None) hold the gravity-neutral specific
    force [0, 0, g], not zeros, which would preintegrate free fall.

    Returns (time (m,), gyro (m,3), accel (m,3), valid (m,) bool)."""
    m = cfg.imu.max_imu_per_scan
    k = min(len(imu_time), m)
    it = np.zeros(m, np.float32)
    ig = np.zeros((m, 3), np.float32)
    ia = np.zeros((m, 3), np.float32)
    ia[:, 2] = cfg.imu.gravity
    it[:k] = imu_time[:k]
    ig[:k] = imu_gyro[:k]
    if imu_accel is not None:
        ia[:k] = imu_accel[:k]
    return it, ig, ia, np.arange(m) < k


def pad_scan(points_xyzi: np.ndarray, cfg: SlamConfig,
             device: torch.device | str = "cpu",
             imu_time: np.ndarray | None = None,
             imu_gyro: np.ndarray | None = None,
             imu_accel: np.ndarray | None = None,
             scan_start: float = 0.0,
             velocity: np.ndarray | None = None,
             angular_rate: np.ndarray | None = None) -> odometry.ScanInput:
    """Pad a raw (P, 4) host cloud to the fixed scan buffer
    (cfg.sensor.max_raw_points rows) on `device`, with the IMU window
    padded by pad_imu_window and, for the velocity front end
    (cfg.imu.deskew_mode == "velocity"), the body-frame ego velocity and
    angular rate at scan time."""
    p = cfg.sensor.max_raw_points
    pts = np.zeros((p, 4), np.float32)
    n = min(len(points_xyzi), p)
    pts[:n] = points_xyzi[:n]

    def dev(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device)

    imu = {}
    if imu_time is not None and len(imu_time):
        it, ig, ia, iv = pad_imu_window(cfg, imu_time, imu_gyro, imu_accel)
        imu = dict(imu_time=dev(it), imu_gyro=dev(ig), imu_accel=dev(ia),
                   imu_valid=torch.from_numpy(iv).to(device))
    has_vel = velocity is not None
    return odometry.ScanInput(
        points=torch.from_numpy(pts).to(device),
        valid=torch.arange(p, device=device) < n,
        scan_start=dev(scan_start), **imu,
        vel=dev(velocity if has_vel else np.zeros(3)),
        ang_rate=dev(angular_rate if angular_rate is not None
                     else np.zeros(3)),
        vel_valid=has_vel)


class VelocityStream:
    """Host-side ego-velocity buffer for the velocity front end: the
    dataPretreatNode vel queue + VelocityData::SyncData's linear
    interpolation (distortionAdjust.cpp:4-98). Feed it lidar-frame twists
    (imu.preintegration.gps_vel_to_lidar); `at(t)` returns the
    interpolated (linear, angular) pair for pad_scan."""

    def __init__(self, max_len: int = 4096):
        self._t: list[float] = []
        self._lin: list[np.ndarray] = []
        self._ang: list[np.ndarray] = []
        self._max = max_len

    def push(self, t: float, linear, angular) -> None:
        self._t.append(float(t))
        self._lin.append(np.asarray(linear, np.float64))
        self._ang.append(np.asarray(angular, np.float64))
        if len(self._t) > self._max:  # drop-oldest, reference deque policy
            del self._t[0], self._lin[0], self._ang[0]

    def at(self, t: float):
        """Interpolated (linear (3,), angular (3,)) at time t, or None if
        the stream does not bracket t (SyncData returns false: the scan is
        then not compensated)."""
        if len(self._t) < 2 or not (self._t[0] <= t <= self._t[-1]):
            return None
        hi = int(np.searchsorted(np.asarray(self._t), t, side="right"))
        hi = min(max(hi, 1), len(self._t) - 1)
        lo = hi - 1
        denom = self._t[hi] - self._t[lo]
        w = (t - self._t[lo]) / denom if denom > 1e-9 else 0.0
        lin = self._lin[lo] + w * (self._lin[hi] - self._lin[lo])
        ang = self._ang[lo] + w * (self._ang[hi] - self._ang[lo])
        return lin, ang


def _loader_keep(points: torch.Tensor, valid: torch.Tensor,
                 cfg: SlamConfig) -> torch.Tensor:
    """The rows the benchmark's loader keeps: valid, on a ring that
    cfg.sensor.downsample_rate does not drop."""
    from ..ops import pretreatment

    ring, ok = pretreatment.compute_ring(points, valid, cfg.sensor.n_scan)
    return ok & (ring % cfg.sensor.downsample_rate == 0)


def compact_scan(points: torch.Tensor, valid: torch.Tensor, cfg: SlamConfig,
                 capacity: int | None = None) -> odometry.ScanInput:
    """The benchmark's data-loader step (bench.py `prep`), on the points'
    device: drop the rings that cfg.sensor.downsample_rate discards anyway
    and pack the rest to the front of a `capacity`-row buffer (default
    cfg.sensor.max_raw_points). points (P, 4) xyzi, valid (P,)."""
    cap = cfg.sensor.max_raw_points if capacity is None else capacity
    dev = points.device
    keep = _loader_keep(points, valid, cfg)
    pos = torch.cumsum(keep.to(torch.int32), 0) - 1
    dest = torch.where(keep & (pos < cap), pos,
                       torch.full_like(pos, cap)).to(torch.int64)
    buf = torch.zeros((cap + 1, 4), dtype=torch.float32, device=dev)
    buf[dest] = points.to(torch.float32)
    cnt = torch.clamp(torch.sum(keep.to(torch.int32)), max=cap)
    return odometry.ScanInput(points=buf[:cap],
                              valid=torch.arange(cap, device=dev) < cnt)


def compact_labels(points: torch.Tensor, valid: torch.Tensor,
                   labels: torch.Tensor, cfg: SlamConfig,
                   capacity: int | None = None) -> np.ndarray:
    """The per-point labels of compact_scan's rows, in its order, as the
    host int32 array SemanticSlam.process_scan takes (`gt_labels`)."""
    cap = cfg.sensor.max_raw_points if capacity is None else capacity
    keep = _loader_keep(points, valid, cfg)
    return labels[keep][:cap].to(torch.int32).cpu().numpy()


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def replay_odometry(scans, cfg: SlamConfig, warmup: int = 0,
                    device: torch.device | str = "cuda") -> ReplayResult:
    """Run the front-end odometry over an iterable of scans: each an
    odometry.ScanInput already padded on `device`, a SyntheticScan-like
    host object (``.points``, ``.valid``, and with cfg.imu.use_imu its
    gyro window ``.imu_time``, ``.gyro``) or a raw (P, 4) numpy array.
    Scans/s counts the scans after the first `warmup`, timed from a device
    sync to a device sync."""
    device = devices.resolve(device)
    state = odometry.init_state(cfg, device)
    poses, kfs, nvs, its = [], [], [], []
    t0 = None
    for i, scan in enumerate(scans):
        if hasattr(scan, "points") and not isinstance(scan,
                                                      odometry.ScanInput):
            use_imu = (cfg.imu.use_imu
                       and getattr(scan, "gyro", None) is not None)
            scan = pad_scan(
                scan.points[scan.valid], cfg, device,
                imu_time=scan.imu_time if use_imu else None,
                imu_gyro=scan.gyro if use_imu else None)
        elif not isinstance(scan, odometry.ScanInput):
            scan = pad_scan(np.asarray(scan), cfg, device)
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
