"""IMU preintegration on-manifold (Forster et al.) and the nav-state
updates of the LiDAR-inertial path (port of
lis_slam_tpu/imu/preintegration.py; reference IMUPreintegration,
subMapOptmizationNode.cpp:2007-2219, imuHandler :429-511,
failureDetection :2222-2238).

The functions keep their inputs' device and dtype. The LIO driver
(pipeline/lio.py) runs them on the host in float64: the `lax.scan`
recurrences of the JAX package become Python loops over the samples that
advance time, ~35 small tensor operations each. One scan's chain (a
21-sample window preintegrated, then the two-window solve) took 5.4 ms
on the host against 15.2 ms as the same functions on the card, float64
or float32 (NVIDIA H100 80GB HBM3, 700 W, and its host; PERF.md). Samples
with dt = 0 are skipped, which is what the JAX package's masked update
does to them.

The noise model is the reference's (imuAccNoise/imuGyrNoise/imuAccBiasN/
imuGyrBiasN, config/params.yaml:82-87).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import ImuConfig
from ..utils import se3, se3_np


class PreintegratedImu(NamedTuple):
    """Delta state between two scan times, in the first frame's body frame."""

    delta_R: torch.Tensor  # (3, 3)
    delta_v: torch.Tensor  # (3,)
    delta_p: torch.Tensor  # (3,)
    delta_t: torch.Tensor  # ()
    # bias Jacobians (first order, Forster eq. 44)
    dR_dbg: torch.Tensor  # (3, 3)
    dv_dbg: torch.Tensor  # (3, 3)
    dv_dba: torch.Tensor  # (3, 3)
    dp_dbg: torch.Tensor  # (3, 3)
    dp_dba: torch.Tensor  # (3, 3)
    cov: torch.Tensor  # (9, 9) [theta, v, p] covariance
    count: int  # integrated samples


class ImuState(NamedTuple):
    """Propagated navigation state (world frame). `P_bias` is the running
    [bg, ba] marginal covariance, the stand-in for the iSAM2 bias marginal
    the reference carries across keys."""

    R: torch.Tensor  # (3, 3)
    v: torch.Tensor  # (3,)
    p: torch.Tensor  # (3,)
    bg: torch.Tensor  # (3,) gyro bias
    ba: torch.Tensor  # (3,) accel bias
    P_bias: torch.Tensor = torch.eye(6, dtype=torch.float64) * 0.1**2


def init_imu_state(cfg: ImuConfig, dtype: torch.dtype = torch.float64,
                   device: torch.device | str = "cpu") -> ImuState:
    """Fresh nav state with the configured bias prior."""
    kw = dict(dtype=dtype, device=device)
    return ImuState(R=torch.eye(3, **kw), v=torch.zeros(3, **kw),
                    p=torch.zeros(3, **kw), bg=torch.zeros(3, **kw),
                    ba=torch.zeros(3, **kw),
                    P_bias=torch.eye(6, **kw) * cfg.bias_prior_sigma**2)


def _window_dt(imu_time: torch.Tensor, valid: torch.Tensor,
               t0=None, t1=None) -> torch.Tensor:
    """Per-sample dt: clipped to [t0, t1] when given, 0 on invalid samples
    and on the first valid one, within [0, 0.1]."""
    t = imu_time
    if t0 is not None:
        t = torch.maximum(t, torch.as_tensor(t0, dtype=t.dtype,
                                             device=t.device))
    if t1 is not None:
        t = torch.minimum(t, torch.as_tensor(t1, dtype=t.dtype,
                                             device=t.device))
    prev_t = torch.cat([t[:1], t[:-1]])
    dt = torch.where(valid, t - prev_t, torch.zeros_like(t))
    first = torch.argmax(valid.to(torch.int32))
    idx = torch.arange(t.shape[0], device=t.device)
    dt = torch.where(idx == first, torch.zeros_like(dt), dt)
    return torch.clamp(dt, 0.0, 0.1)


def _right_jacobian(phi: torch.Tensor) -> torch.Tensor:
    """SO(3) right Jacobian Jr(phi), batched over leading dims."""
    theta2 = torch.sum(phi * phi, dim=-1)
    theta = torch.sqrt(torch.clamp(theta2, min=1e-24))
    W = se3.hat(phi)
    small = theta2 < 1e-12
    t2 = torch.clamp(theta2, min=1e-24)
    a = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / t2)
    b = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (theta - torch.sin(theta))
                    / torch.clamp(theta2 * theta, min=1e-24))
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device).expand(W.shape)
    return eye - a[..., None, None] * W + b[..., None, None] * (W @ W)


def preintegrate(imu_time: torch.Tensor, gyro: torch.Tensor,
                 accel: torch.Tensor, valid: torch.Tensor, bg: torch.Tensor,
                 ba: torch.Tensor, cfg: ImuConfig, t0=None,
                 t1=None) -> PreintegratedImu:
    """Integrate the window with bias-corrected measurements (Euler
    forward, as gtsam's default). With `t0`/`t1` the sample times clamp to
    [t0, t1], so integration spans exactly the pose-pair interval (the
    reference integrates between consecutive odometry stamps,
    subMapOptmizationNode.cpp:2096-2118)."""
    dt = _window_dt(imu_time, valid, t0, t1)
    dts = dt.tolist()  # the host decides which samples advance time
    steps = [i for i, d in enumerate(dts) if d > 0]
    kw = dict(dtype=gyro.dtype, device=gyro.device)
    w = gyro - bg
    a = accel - ba
    # the parts that do not depend on the running delta, for all samples
    wdt = w * dt[:, None]
    dR_inc = se3.so3_exp(wdt)
    Jr_dt = _right_jacobian(wdt) * dt[:, None, None]
    a_hat = se3.hat(a)
    q = torch.cat([torch.full((3,), cfg.gyr_noise**2, **kw),
                   torch.full((3,), cfg.acc_noise**2, **kw)])

    R = torch.eye(3, **kw)
    v = torch.zeros(3, **kw)
    p = torch.zeros(3, **kw)
    dR_dbg, dv_dbg, dv_dba, dp_dbg, dp_dba = (
        torch.zeros((3, 3), **kw) for _ in range(5))
    cov = torch.zeros((9, 9), **kw)
    I3, Z3 = torch.eye(3, **kw), torch.zeros((3, 3), **kw)
    for i in steps:
        h, h2 = dts[i], dts[i] * dts[i]
        dRi = dR_inc[i]
        a_rot = R @ a[i]
        Ra_hat = R @ a_hat[i]
        Ra_dR = Ra_hat @ dR_dbg
        # covariance propagation (theta, v, p); Q_d = Q_c / dt
        A = torch.cat([
            torch.cat([dRi.T, Z3, Z3], 1),
            torch.cat([-Ra_hat * h, I3, Z3], 1),
            torch.cat([-0.5 * Ra_hat * h2, I3 * h, I3], 1)], 0)
        B = torch.cat([torch.cat([Jr_dt[i], Z3], 1),
                       torch.cat([Z3, R * h], 1),
                       torch.cat([Z3, 0.5 * R * h2], 1)], 0)
        cov = A @ cov @ A.T + (B * (q / max(h, 1e-4))) @ B.T
        # bias Jacobians (from the previous step's values)
        dp_dbg = dp_dbg + dv_dbg * h - 0.5 * Ra_dR * h2
        dp_dba = dp_dba + dv_dba * h - 0.5 * R * h2
        dv_dbg = dv_dbg - Ra_dR * h
        dv_dba = dv_dba - R * h
        dR_dbg = dRi.T @ dR_dbg - Jr_dt[i]
        # state
        p = p + v * h + 0.5 * a_rot * h2
        v = v + a_rot * h
        R = R @ dRi
    return PreintegratedImu(
        delta_R=R, delta_v=v, delta_p=p, delta_t=torch.sum(dt),
        dR_dbg=dR_dbg, dv_dbg=dv_dbg, dv_dba=dv_dba, dp_dbg=dp_dbg,
        dp_dba=dp_dba, cov=cov, count=len(steps))


def predict(state: ImuState, pre: PreintegratedImu,
            gravity: float) -> ImuState:
    """Propagate the nav state through a preintegrated delta (gtsam
    ImuFactor predict; the next scan's initial guess)."""
    g = torch.tensor([0.0, 0.0, -gravity], dtype=state.v.dtype,
                     device=state.v.device)
    dt = pre.delta_t
    return state._replace(
        R=state.R @ pre.delta_R,
        v=state.v + g * dt + state.R @ pre.delta_v,
        p=state.p + state.v * dt + 0.5 * g * dt * dt + state.R @ pre.delta_p)


def correct_delta(pre: PreintegratedImu, dbg: torch.Tensor,
                  dba: torch.Tensor):
    """First-order bias correction of the preintegrated deltas."""
    dR = pre.delta_R @ se3.so3_exp(pre.dR_dbg @ dbg)
    dv = pre.delta_v + pre.dv_dbg @ dbg + pre.dv_dba @ dba
    dp = pre.delta_p + pre.dp_dbg @ dbg + pre.dp_dba @ dba
    return dR, dv, dp


def predict_path(imu_time: torch.Tensor, gyro: torch.Tensor,
                 accel: torch.Tensor, valid: torch.Tensor, state: ImuState,
                 cfg: ImuConfig):
    """IMU-rate odometry: the world-frame pose at every sample of the
    window, from the last optimized nav state with the current biases (the
    reference's odometry/imu stream, subMapOptmizationNode.cpp:429-511).
    Returns (R (M,3,3), v (M,3), p (M,3)); invalid samples repeat the
    previous pose."""
    dt = _window_dt(imu_time, valid)
    dts = dt.tolist()
    g = torch.tensor([0.0, 0.0, -cfg.gravity], dtype=state.v.dtype,
                     device=state.v.device)
    dR_inc = se3.so3_exp((gyro - state.bg) * dt[:, None])
    a = accel - state.ba
    R, v, p = state.R, state.v, state.p
    Rs, vs, ps = [], [], []
    for i, h in enumerate(dts):
        if h > 0:
            a_w = R @ a[i] + g
            p = p + v * h + 0.5 * a_w * h * h
            v = v + a_w * h
            R = R @ dR_inc[i]
        Rs.append(R)
        vs.append(v)
        ps.append(p)
    return torch.stack(Rs), torch.stack(vs), torch.stack(ps)


def imu_to_lidar(gyro: torch.Tensor, accel: torch.Tensor, cfg: ImuConfig):
    """Rotate raw IMU measurements into the lidar frame (imuConverter,
    utility.h:482-517: acc/gyr left-multiplied by extRot)."""
    R = torch.tensor(cfg.extrinsic_rot, dtype=gyro.dtype, device=gyro.device)
    return gyro @ R.T, accel @ R.T


def gps_vel_to_lidar(linear, angular, cfg: ImuConfig):
    """Rotate a GPS velocity twist into the lidar frame (gpsVelConverter,
    utility.h:519-540: linear and angular velocity left-multiplied by
    extRot). Numpy in and out, at the GPS message rate."""
    R = np.asarray(cfg.extrinsic_rot, np.float64)
    return (R @ np.asarray(linear, np.float64),
            R @ np.asarray(angular, np.float64))


def remap_imu_orientation(rpy, cfg: ImuConfig):
    """imuConverter's orientation remap (utility.h:500-508): the absolute
    IMU orientation is post-multiplied by the extrinsicRPY rotation
    (q_final = q_from * extQRPY). Numpy in and out, once per scan."""
    R_in = se3_np.pose_to_matrix(np.concatenate(
        [np.asarray(rpy, np.float64), np.zeros(3)]))[:3, :3]
    R_out = R_in @ np.asarray(cfg.extrinsic_rpy, np.float64)
    pitch = -np.arcsin(np.clip(R_out[2, 0], -1.0, 1.0))
    roll = np.arctan2(R_out[2, 1], R_out[2, 2])
    yaw = np.arctan2(R_out[1, 0], R_out[0, 0])
    return np.array([roll, pitch, yaw], np.float64)


def failure_detection(velocity: torch.Tensor, bg: torch.Tensor,
                      ba: torch.Tensor) -> torch.Tensor:
    """failureDetection (subMapOptmizationNode.cpp:2222-2238): reset when
    |v| > 30 m/s or |bias| > 1.0."""
    norm = torch.linalg.vector_norm
    return (norm(velocity) > 30.0) | (norm(ba) > 1.0) | (norm(bg) > 1.0)


def _whiten(S: torch.Tensor, Jb: torch.Tensor, rb: torch.Tensor):
    """Whiten a 3-residual block by its covariance: L^-1 J, L^-1 r."""
    L = torch.linalg.cholesky(S + 1e-12 * torch.eye(3, dtype=S.dtype,
                                                    device=S.device))
    solve = torch.linalg.solve_triangular
    return (solve(L, Jb, upper=False),
            solve(L, rb[:, None], upper=False)[:, 0])


def velocity_bias_update2(state: ImuState, pre1: PreintegratedImu,
                          pre2: PreintegratedImu, pose0: torch.Tensor,
                          pose1: torch.Tensor, pose2: torch.Tensor,
                          v0_est: torch.Tensor, cfg: ImuConfig):
    """Two-window joint (bg, ba, v0) MAP solve from three lidar-anchored
    poses, each residual block whitened by its covariance (the
    preintegration blocks plus the pose-anchor noise), against the
    random-walk-inflated bias marginal and a loose v0 prior. Two windows
    separate the accel bias from a start-velocity error, as consecutive
    iSAM2 ImuFactors sharing a velocity do.

    Returns (new ImuState anchored at pose2 with the propagated velocity,
    v1), v1 the corrected velocity at pose1 (the next call's v0_est). A
    step cut by a safety clamp keeps the inflated prior as the marginal."""
    kw = dict(dtype=state.v.dtype, device=state.v.device)
    pose0, pose1, pose2 = (x.to(**kw) for x in (pose0, pose1, pose2))
    g = torch.tensor([0.0, 0.0, -cfg.gravity], **kw)
    R0, R1, R2 = (se3.euler_to_rot(x[:3]) for x in (pose0, pose1, pose2))
    p0, p1, p2 = pose0[3:], pose1[3:], pose2[3:]
    dt1 = torch.clamp(pre1.delta_t, min=1e-3)
    dt2 = torch.clamp(pre2.delta_t, min=1e-3)

    rR1 = se3.so3_log(pre1.delta_R.T @ (R0.T @ R1))
    rR2 = se3.so3_log(pre2.delta_R.T @ (R1.T @ R2))
    rp1 = R0.T @ (p1 - p0 - v0_est * dt1 - 0.5 * g * dt1 * dt1) - pre1.delta_p
    v1_est = v0_est + g * dt1 + R0 @ pre1.delta_v
    rp2 = R1.T @ (p2 - p1 - v1_est * dt2 - 0.5 * g * dt2 * dt2) - pre2.delta_p

    R1tR0 = R1.T @ R0
    Z, I3 = torch.zeros((3, 3), **kw), torch.eye(3, **kw)
    # unknowns [dbg, dba, dv0]; Jacobian rows per residual block
    J_R1 = torch.cat([pre1.dR_dbg, Z, Z], 1)
    J_R2 = torch.cat([pre2.dR_dbg, Z, Z], 1)
    J_p1 = torch.cat([pre1.dp_dbg, pre1.dp_dba, R0.T * dt1], 1)
    J_p2 = torch.cat([pre2.dp_dbg + R1tR0 @ pre1.dv_dbg * dt2,
                      pre2.dp_dba + R1tR0 @ pre1.dv_dba * dt2,
                      R1.T * dt2], 1)
    s_rot2 = 2.0 * cfg.pose_anchor_rot_sigma**2
    s_pos2 = 2.0 * cfg.pose_anchor_pos_sigma**2
    S_R1 = pre1.cov[0:3, 0:3] + s_rot2 * I3
    S_R2 = pre2.cov[0:3, 0:3] + s_rot2 * I3
    S_p1 = pre1.cov[6:9, 6:9] + s_pos2 * I3
    S_p2 = (pre2.cov[6:9, 6:9] + s_pos2 * I3
            + dt2 * dt2 * (R1tR0 @ pre1.cov[3:6, 3:6] @ R1tR0.T))
    blocks = [_whiten(S_R1, J_R1, rR1), _whiten(S_R2, J_R2, rR2),
              _whiten(S_p1, J_p1, rp1), _whiten(S_p2, J_p2, rp2)]
    Jw = torch.cat([b[0] for b in blocks], 0)  # (12, 9)
    rw = torch.cat([b[1] for b in blocks])

    rw_var = torch.cat([torch.full((3,), cfg.gyr_bias_noise**2, **kw),
                        torch.full((3,), cfg.acc_bias_noise**2, **kw)])
    P_b = state.P_bias + torch.diag(rw_var) * (dt1 + dt2)
    Lam = torch.zeros((9, 9), **kw)
    Lam[:6, :6] = torch.linalg.inv(P_b)
    Lam[6:, 6:] = I3 / cfg.v0_prior_sigma**2
    H = Jw.T @ Jw + Lam
    delta = torch.linalg.solve(H, Jw.T @ rw)
    # wide final-safety clamps only (the failure gate is |bias| > 1.0)
    dbg = torch.clamp(delta[0:3], -0.1, 0.1)
    dba = torch.clamp(delta[3:6], -0.2, 0.2)
    dv0 = delta[6:9]
    clamped = (torch.any(torch.abs(delta[0:3]) > 0.1)
               | torch.any(torch.abs(delta[3:6]) > 0.2))
    P_post = torch.where(clamped, P_b, torch.linalg.inv(H)[:6, :6])

    v0 = v0_est + dv0
    v1 = v0 + g * dt1 + R0 @ (pre1.delta_v + pre1.dv_dbg @ dbg
                              + pre1.dv_dba @ dba)
    v2 = v1 + g * dt2 + R1 @ (pre2.delta_v + pre2.dv_dbg @ dbg
                              + pre2.dv_dba @ dba)
    return ImuState(R=R2, v=v2, p=p2, bg=state.bg + dbg, ba=state.ba + dba,
                    P_bias=P_post), v1


def velocity_bias_update(state: ImuState, pre: PreintegratedImu,
                         pose_prev: torch.Tensor, pose_new: torch.Tensor,
                         cfg: ImuConfig) -> ImuState:
    """One-window refresh from the lidar pose pair: the velocity consistent
    with the observed displacement, and the gyro-bias MAP step from the
    whitened rotation residual against the running marginal. The accel
    bias is not observable from one window and stays. The bg marginal is
    replaced and the stale bg-ba cross blocks are dropped, so P_bias stays
    positive definite for the next two-window solve."""
    kw = dict(dtype=state.v.dtype, device=state.v.device)
    pose_prev, pose_new = pose_prev.to(**kw), pose_new.to(**kw)
    R0 = se3.euler_to_rot(pose_prev[:3])
    R1 = se3.euler_to_rot(pose_new[:3])
    p0, p1 = pose_prev[3:], pose_new[3:]
    g = torch.tensor([0.0, 0.0, -cfg.gravity], **kw)
    dt = torch.clamp(pre.delta_t, min=1e-3)
    v_new = (p1 - p0 - 0.5 * g * dt * dt - R0 @ pre.delta_p) / dt
    rot_res = se3.so3_log(pre.delta_R.T @ (R0.T @ R1))
    I3 = torch.eye(3, **kw)
    S_R = pre.cov[0:3, 0:3] + 2.0 * cfg.pose_anchor_rot_sigma**2 * I3
    Jw, rw = _whiten(S_R, pre.dR_dbg, rot_res)
    P_bg = state.P_bias[:3, :3] + cfg.gyr_bias_noise**2 * dt * I3
    H = Jw.T @ Jw + torch.linalg.inv(P_bg)
    dbg_raw = torch.linalg.solve(H, Jw.T @ rw)
    dbg = torch.clamp(dbg_raw, -0.1, 0.1)
    bg_marg = torch.where(torch.any(torch.abs(dbg_raw) > 0.1), P_bg,
                          torch.linalg.inv(H))
    P_bias = state.P_bias.clone()
    P_bias[:3, :3] = bg_marg
    P_bias[:3, 3:] = 0.0
    P_bias[3:, :3] = 0.0
    return ImuState(R=R1, v=v_new, p=p1, bg=state.bg + dbg, ba=state.ba,
                    P_bias=P_bias)
