"""Tightly-coupled LiDAR-inertial odometry driver, params_lio (port of
lis_slam_tpu/pipeline/lio.py; reference IMUPreintegration,
subMapOptmizationNode.cpp:2007-2219 + imuHandler :429-511).

The navigation state (R, v, p, biases) lives on the host in float64: each
scan preintegrates the previous IMU window for the initial guess fed to
`odometry.odom_step` on the device, then refreshes velocity and biases from
the lidar-optimized pose pair, which is read back once per scan, and
applies the reference's failure detection (velocity/bias divergence ->
reset, :2222-2238) through a sticky latch read every
`failure_check_every` scans.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from ..config import SlamConfig
from ..imu import preintegration as pi
from ..utils import device as devices, se3
from . import driver, odometry

_HOST = dict(dtype=torch.float64, device="cpu")


def _host(a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), **_HOST)


def _lio_prestep(cur_gyro, cur_accel, prev_time, prev_gyro_l, prev_accel_l,
                 prev_valid, prev_start, cur_start, imu_state, cfg):
    """The pre-odometry IMU chain: the current window into the lidar frame
    (for the deskew), the previous window preintegrated over the realized
    inter-scan interval [prev_start, cur_start] (the delta from pose_{i-1}
    to pose_i), the predicted nav state and the initial guess. Returns
    (pre, guess, gyro_l, accel_l, vel_body, guess_ok)."""
    g_j, a_j = pi.imu_to_lidar(cur_gyro, cur_accel, cfg.imu)
    pre = pi.preintegrate(prev_time, prev_gyro_l, prev_accel_l, prev_valid,
                          imu_state.bg, imu_state.ba, cfg.imu, t0=prev_start,
                          t1=cur_start)
    pred = pi.predict(imu_state, pre, cfg.imu.gravity)
    guess = torch.cat([se3.rot_to_euler(pred.R), pred.p])
    # predicted body-frame velocity at scan start, for the positional
    # deskew term
    vel_body = pred.R.T @ pred.v
    return pre, guess, g_j, a_j, vel_body, pre.count >= 1


def _lio_poststep2(imu_state, pre1, pre2, pose0, pose1, pose2, v0_est,
                   fail_acc, cfg):
    """Two-window bias/velocity solve + sticky failure latch (the steady
    state)."""
    new_state, v1 = pi.velocity_bias_update2(
        imu_state, pre1, pre2, pose0, pose1, pose2, v0_est, cfg.imu)
    fail = bool(pi.failure_detection(new_state.v, new_state.bg,
                                     new_state.ba))
    return new_state, v1, fail_acc or fail


def _lio_poststep(imu_state, pre, last_pose6, pose6, fail_acc, cfg):
    """One-window bias/velocity refresh + sticky failure latch (the first
    window after an (re)init). The latch keeps a divergence on any scan
    until the sampled check reads and resets it (the reference checks on
    every update, subMapOptmizationNode.cpp:2153-2156)."""
    new_state = pi.velocity_bias_update(imu_state, pre, last_pose6, pose6,
                                        cfg.imu)
    fail = bool(pi.failure_detection(new_state.v, new_state.bg,
                                     new_state.ba))
    return new_state, fail_acc or fail


@dataclass
class LioDiagnostics:
    n_resets: int = 0
    n_scans: int = 0
    imu_s: float = 0.0  # host seconds in the IMU chain (pre + post step)


class LioOdometry:
    """Host loop: IMU windows + the odometry step on `device`."""

    def __init__(self, cfg: SlamConfig, device: torch.device | str = "cuda"):
        if not cfg.imu.use_imu:
            raise ValueError("LIO requires imu.use_imu=True")
        self.cfg = cfg
        self.device = devices.resolve(device)
        self.state = odometry.init_state(cfg, self.device)
        self.imu_state = pi.init_imu_state(cfg.imu)
        self.diag = LioDiagnostics()
        self._last_pose6: torch.Tensor | None = None  # host, float64
        self._fail_acc = False  # sticky failure latch
        # sliding window pair for the two-window bias solve
        self._prev_pre = None  # preintegration of the previous window
        self._prev_pose6 = None  # pose at that window's start (pose0)
        self._v0 = torch.zeros(3, **_HOST)  # velocity estimate at pose0
        # the previous scan's IMU window (lidar frame) + its scan_start,
        # preintegrated at the next scan over the realized interval
        self._prev_win = None  # (time, gyro_l, accel_l, valid, scan_start)

    def predict_imu_rate(self, imu_time: np.ndarray, imu_gyro: np.ndarray,
                         imu_accel: np.ndarray) -> torch.Tensor:
        """IMU-rate odometry (the reference's odometry/imu stream from
        imuHandler, subMapOptmizationNode.cpp:429-511): the world pose6 at
        every valid sample of the window, propagated from the current nav
        state with the current biases. Returns (k, 6) float32 on the
        odometry device."""
        it, ig, ia, iv = driver.pad_imu_window(self.cfg, imu_time, imu_gyro,
                                               imu_accel)
        k = int(iv.sum())
        ig_l, ia_l = pi.imu_to_lidar(_host(ig), _host(ia), self.cfg.imu)
        Rs, _vs, ps = pi.predict_path(_host(it), ig_l, ia_l,
                                      torch.from_numpy(iv), self.imu_state,
                                      self.cfg.imu)
        poses = se3.matrix_to_pose(se3.make_transform(Rs, ps))[:k]
        return poses.to(self.device, torch.float32)

    def _reset_imu(self):
        """resetParams: re-anchor at the current lidar pose."""
        pose = self.state.pose.to(**_HOST)
        self.imu_state = pi.init_imu_state(self.cfg.imu)._replace(
            R=se3.euler_to_rot(pose[:3]), p=pose[3:])
        self._prev_pre = None
        self._prev_pose6 = None
        self._v0 = torch.zeros(3, **_HOST)
        self.diag.n_resets += 1

    def process_scan(
        self,
        points: np.ndarray,  # (P, 4) raw scan
        imu_time: np.ndarray,  # (M,) absolute seconds covering gap + sweep
        imu_gyro: np.ndarray,  # (M, 3)
        imu_accel: np.ndarray,  # (M, 3)
        scan_start: float,
        imu_rpy: np.ndarray | None = None,  # (3,) orientation at scan start
        failure_check_every: int = 10,
    ) -> torch.Tensor:
        """One scan through the LIO chain. Returns the optimized pose6 on
        the odometry device."""
        cfg = self.cfg
        dev = self.device
        it, ig, ia, iv = driver.pad_imu_window(cfg, imu_time, imu_gyro,
                                               imu_accel)
        k = int(iv.sum())
        # the step's scan_start is float32, as the JAX package's
        start = float(np.float32(scan_start))
        it_h, iv_h = _host(it), torch.from_numpy(iv)

        t_imu = time.perf_counter()
        pre = guess = g_l = a_l = vel_body = None
        guess_ok = False
        if k >= 2 and self._prev_win is not None:
            pre, guess, g_l, a_l, vel_body, guess_ok = _lio_prestep(
                _host(ig), _host(ia), *self._prev_win, start,
                self.imu_state, cfg)
        elif k >= 2:
            g_l, a_l = pi.imu_to_lidar(_host(ig), _host(ia), cfg.imu)
        self.diag.imu_s += time.perf_counter() - t_imu

        sin = driver.pad_scan(points, cfg, dev, scan_start=scan_start)
        extra = {}
        if g_l is not None:
            extra.update(imu_time=torch.from_numpy(it).to(dev),
                         imu_gyro=g_l.to(dev, torch.float32),
                         imu_valid=iv_h.to(dev))
        if guess is not None and self._last_pose6 is not None:
            extra.update(init_guess=guess.to(dev, torch.float32),
                         init_guess_valid=guess_ok)
            # positional deskew once the velocity estimate is live (after
            # the first bias/velocity refresh)
            if self._prev_pre is not None:
                extra["deskew_vel"] = vel_body.to(dev, torch.float32)
        if imu_rpy is not None:
            # absolute-orientation remap (imuConverter extRPY path,
            # utility.h:500-508), distinct from the extRot rate rotation
            rpy = pi.remap_imu_orientation(imu_rpy, cfg.imu)
            extra.update(imu_rpy=torch.tensor(rpy, dtype=torch.float32,
                                              device=dev),
                         imu_rpy_valid=True)
        sin = sin._replace(**extra)

        self.state, out = odometry.odom_step(self.state, sin, cfg)
        pose6 = out.pose
        pose_h = pose6.to(**_HOST)  # the one readback of the scan

        t_imu = time.perf_counter()
        # velocity/bias refresh from the lidar pose anchors
        if pre is not None and self._last_pose6 is not None:
            last6 = self._last_pose6
            if self._prev_pre is not None:
                self.imu_state, self._v0, self._fail_acc = _lio_poststep2(
                    self.imu_state, self._prev_pre, pre, self._prev_pose6,
                    last6, pose_h, self._v0, self._fail_acc, cfg)
            else:
                self.imu_state, self._fail_acc = _lio_poststep(
                    self.imu_state, pre, last6, pose_h, self._fail_acc, cfg)
                self._v0 = self.imu_state.v
            self._prev_pre = pre
            self._prev_pose6 = last6
            if self.diag.n_scans % failure_check_every == 0:
                if self._fail_acc:
                    self._reset_imu()
                self._fail_acc = False
        else:
            self.imu_state = self.imu_state._replace(
                R=se3.euler_to_rot(pose_h[:3]), p=pose_h[3:])
        # this scan's window (lidar frame) for the next prestep
        self._prev_win = ((it_h, g_l, a_l, iv_h, start) if g_l is not None
                          else None)
        self._last_pose6 = pose_h
        self.diag.imu_s += time.perf_counter() - t_imu
        self.diag.n_scans += 1
        return pose6
