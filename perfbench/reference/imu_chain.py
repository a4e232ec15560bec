"""Plain restatement of the LIO chain around the front end, in numpy.

What lis_slam_torch/pipeline/lio.py `LioOdometry.process_scan` and
imu/preintegration.py compute on the host, written from their
mathematics (after IMUPreintegration, subMapOptmizationNode.cpp:2007-2238):

- each scan's IMU rows, padded to `max_imu_per_scan` (accel padding holds
  [0, 0, g]), rotated into the lidar frame by the extrinsic rotation;
- from the second scan, the previous window preintegrated (Forster et
  al.: Euler steps, bias Jacobians, the [theta, v, p] covariance) over the
  realized interval between the two scans' start stamps, the nav state
  propagated through it: the initial guess [roll, pitch, yaw, x, y, z] of
  the scan-to-map solve, and the predicted body velocity, the deskew's
  positional term;
- after the solve, the nav state refreshed from the lidar poses: one
  window's velocity and gyro-bias step, then each scan the two-window
  (bg, ba, v0) MAP solve, each residual block whitened by its covariance;
  a sticky divergence latch (|v| > 30 m/s or a bias over 1) read every
  10th scan, which re-anchors the chain at the current pose;
- the deskew (lis_slam_torch/ops/deskew.py, after laserProcessing.cpp
  imuDeskewInfo :211-266, findRotation :368-400, deskewPoint :427-462):
  the lidar-frame gyro integrated per axis from the first valid sample,
  each point rotated into the frame at the earliest point time, plus the
  body velocity times its time offset once the velocity is live.

The chain follows the program's answers: its lidar poses, the float32
poses the front end returned, anchor each refresh, as the program's own do.
It runs in float64, or in the control's float32 (the chain is stated in
float64); the deskew in float64, or with the control's bfloat16 storage
(the program's deskew is float32). It imports nothing of the program.
"""

from __future__ import annotations

import numpy as np
from scipy.linalg import solve_triangular

from .numerics import Numerics

FAILURE_CHECK_EVERY = 10


def _hat(w):
    x, y, z = w
    return np.array([[0.0, -z, y], [z, 0.0, -x], [-y, x, 0.0]], w.dtype)


def _so3_exp(w):
    t2 = float(w @ w)
    if t2 < 1e-12:
        a, b = 1.0 - t2 / 6.0, 0.5 - t2 / 24.0
    else:
        t = np.sqrt(t2)
        a, b = np.sin(t) / t, (1.0 - np.cos(t)) / t2
    W = _hat(w)
    return (np.eye(3, dtype=w.dtype) + w.dtype.type(a) * W
            + w.dtype.type(b) * (W @ W))


def _right_jacobian(w):
    t2 = float(w @ w)
    if t2 < 1e-12:
        a, b = 0.5 - t2 / 24.0, 1.0 / 6.0 - t2 / 120.0
    else:
        t = np.sqrt(t2)
        a, b = (1.0 - np.cos(t)) / t2, (t - np.sin(t)) / (t2 * t)
    W = _hat(w)
    return (np.eye(3, dtype=w.dtype) - w.dtype.type(a) * W
            + w.dtype.type(b) * (W @ W))


def _so3_log(R):
    tr = R[0, 0] + R[1, 1] + R[2, 2]
    th = np.arccos(np.clip((tr - 1.0) / 2.0, -1.0, 1.0))
    if th < 1e-6:
        scale = 0.5 + th * th / 12.0
    else:
        scale = th / (2.0 * max(np.sin(th), 1e-12))
    D = R - R.T
    return R.dtype.type(scale) * np.array([D[2, 1], D[0, 2], D[1, 0]],
                                          R.dtype)


def euler_to_rot(rpy):
    r, p, y = rpy
    cr, sr, cp, sp = np.cos(r), np.sin(r), np.cos(p), np.sin(p)
    cy, sy = np.cos(y), np.sin(y)
    return np.array([[cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr],
                     [sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr],
                     [-sp, cp * sr, cp * cr]], np.asarray(rpy).dtype)


def rot_to_euler(R):
    return np.array([np.arctan2(R[2, 1], R[2, 2]),
                     np.arcsin(np.clip(-R[2, 0], -1.0, 1.0)),
                     np.arctan2(R[1, 0], R[0, 0])], R.dtype)


class Chain:
    """One session's chain in `dtype` (np.float64, or np.float32)."""

    def __init__(self, imu: dict, dtype=np.float64):
        self.c, self.dt = imu, dtype
        self.R_ext = np.asarray(imu["extrinsic_rot"], dtype)
        self.g = np.array([0.0, 0.0, -imu["gravity"]], dtype)
        self._init_state(np.eye(3, dtype=dtype), np.zeros(3, dtype))
        self.prev_pre = self.prev_pose = self.prev_win = self.last = None
        self.v0 = np.zeros(3, dtype)
        self.fail = False
        self.n = 0

    def _init_state(self, R, p):
        d = self.dt
        self.R, self.p = R, p
        self.v, self.bg, self.ba = (np.zeros(3, d) for _ in range(3))
        self.P = np.eye(6, dtype=d) * d(self.c["bias_prior_sigma"] ** 2)

    def _f(self, x):
        return np.asarray(x, self.dt)

    # -- one window --
    def pad(self, time, gyro, accel):
        m = int(self.c["max_imu_per_scan"])
        k = min(len(time), m)
        it = np.zeros(m, np.float32)
        ig = np.zeros((m, 3), np.float32)
        ia = np.zeros((m, 3), np.float32)
        ia[:, 2] = self.c["gravity"]
        it[:k], ig[:k], ia[:k] = time[:k], gyro[:k], accel[:k]
        return (self._f(it), self._f(ig) @ self.R_ext.T,
                self._f(ia) @ self.R_ext.T, np.arange(m) < k, k)

    def _window_dt(self, t, valid, t0, t1):
        t = np.minimum(np.maximum(t, self.dt(t0)), self.dt(t1))
        prev = np.concatenate([t[:1], t[:-1]])
        dt = np.where(valid, t - prev, 0.0).astype(self.dt)
        dt[int(np.argmax(valid))] = 0.0
        return np.clip(dt, 0.0, 0.1)

    def preintegrate(self, win, t1):
        t, gyro, accel, valid, t0 = win
        d, c = self.dt, self.c
        dt = self._window_dt(t, valid, t0, t1)
        w, a = gyro - self.bg, accel - self.ba
        q = np.array([c["gyr_noise"] ** 2] * 3 + [c["acc_noise"] ** 2] * 3, d)
        R, v, p = np.eye(3, dtype=d), np.zeros(3, d), np.zeros(3, d)
        dR_dbg, dv_dbg, dv_dba, dp_dbg, dp_dba = (np.zeros((3, 3), d)
                                                  for _ in range(5))
        cov = np.zeros((9, 9), d)
        I3, Z3 = np.eye(3, dtype=d), np.zeros((3, 3), d)
        count = 0
        for i in np.flatnonzero(dt > 0):
            h = dt[i]
            h2 = h * h
            wdt = w[i] * h
            dRi, Jr_dt = _so3_exp(wdt), _right_jacobian(wdt) * h
            a_hat = _hat(a[i])
            a_rot, Ra_hat = R @ a[i], R @ a_hat
            Ra_dR = Ra_hat @ dR_dbg
            A = np.block([[dRi.T, Z3, Z3], [-Ra_hat * h, I3, Z3],
                          [-0.5 * Ra_hat * h2, I3 * h, I3]]).astype(d)
            B = np.block([[Jr_dt, Z3], [Z3, R * h],
                          [Z3, 0.5 * R * h2]]).astype(d)
            cov = A @ cov @ A.T + (B * (q / d(max(h, 1e-4)))) @ B.T
            dp_dbg = dp_dbg + dv_dbg * h - 0.5 * Ra_dR * h2
            dp_dba = dp_dba + dv_dba * h - 0.5 * R * h2
            dv_dbg = dv_dbg - Ra_dR * h
            dv_dba = dv_dba - R * h
            dR_dbg = dRi.T @ dR_dbg - Jr_dt
            p = p + v * h + 0.5 * a_rot * h2
            v = v + a_rot * h
            R = R @ dRi
            count += 1
        return dict(dR=R, dv=v, dp=p, dt=d(np.sum(dt)), dR_dbg=dR_dbg,
                    dv_dbg=dv_dbg, dv_dba=dv_dba, dp_dbg=dp_dbg,
                    dp_dba=dp_dba, cov=cov, count=count)

    # -- the refresh after the solve --
    def _whiten(self, S, J, r):
        L = np.linalg.cholesky(S + self.dt(1e-12) * np.eye(3, dtype=self.dt))
        return (solve_triangular(L, J, lower=True),
                solve_triangular(L, r, lower=True))

    def _update1(self, pre, pose0, pose1):
        d, c = self.dt, self.c
        R0, R1 = euler_to_rot(pose0[:3]), euler_to_rot(pose1[:3])
        p0, p1 = pose0[3:], pose1[3:]
        dt = max(pre["dt"], d(1e-3))
        v_new = (p1 - p0 - 0.5 * self.g * dt * dt - R0 @ pre["dp"]) / dt
        res = _so3_log(pre["dR"].T @ (R0.T @ R1))
        I3 = np.eye(3, dtype=d)
        S = pre["cov"][0:3, 0:3] + d(2.0 * c["pose_anchor_rot_sigma"] ** 2) * I3
        Jw, rw = self._whiten(S, pre["dR_dbg"], res)
        P_bg = self.P[:3, :3] + d(c["gyr_bias_noise"] ** 2) * dt * I3
        H = Jw.T @ Jw + np.linalg.inv(P_bg)
        raw = np.linalg.solve(H, Jw.T @ rw)
        dbg = np.clip(raw, -0.1, 0.1)
        P = self.P.copy()
        P[:3, :3] = P_bg if np.any(np.abs(raw) > 0.1) else np.linalg.inv(H)
        P[:3, 3:] = 0.0
        P[3:, :3] = 0.0
        self.R, self.v, self.p = R1, v_new, p1
        self.bg, self.P = self.bg + dbg, P

    def _update2(self, pre1, pre2, pose0, pose1, pose2):
        d, c, g = self.dt, self.c, self.g
        R0, R1, R2 = (euler_to_rot(x[:3]) for x in (pose0, pose1, pose2))
        p0, p1, p2 = pose0[3:], pose1[3:], pose2[3:]
        dt1, dt2 = max(pre1["dt"], d(1e-3)), max(pre2["dt"], d(1e-3))
        v0e = self.v0
        rR1 = _so3_log(pre1["dR"].T @ (R0.T @ R1))
        rR2 = _so3_log(pre2["dR"].T @ (R1.T @ R2))
        rp1 = R0.T @ (p1 - p0 - v0e * dt1 - 0.5 * g * dt1 * dt1) - pre1["dp"]
        v1e = v0e + g * dt1 + R0 @ pre1["dv"]
        rp2 = R1.T @ (p2 - p1 - v1e * dt2 - 0.5 * g * dt2 * dt2) - pre2["dp"]
        R1tR0 = R1.T @ R0
        Z, I3 = np.zeros((3, 3), d), np.eye(3, dtype=d)
        J_R1 = np.hstack([pre1["dR_dbg"], Z, Z])
        J_R2 = np.hstack([pre2["dR_dbg"], Z, Z])
        J_p1 = np.hstack([pre1["dp_dbg"], pre1["dp_dba"], R0.T * dt1])
        J_p2 = np.hstack([pre2["dp_dbg"] + R1tR0 @ pre1["dv_dbg"] * dt2,
                          pre2["dp_dba"] + R1tR0 @ pre1["dv_dba"] * dt2,
                          R1.T * dt2])
        sr2 = d(2.0 * c["pose_anchor_rot_sigma"] ** 2)
        sp2 = d(2.0 * c["pose_anchor_pos_sigma"] ** 2)
        blocks = [
            self._whiten(pre1["cov"][0:3, 0:3] + sr2 * I3, J_R1, rR1),
            self._whiten(pre2["cov"][0:3, 0:3] + sr2 * I3, J_R2, rR2),
            self._whiten(pre1["cov"][6:9, 6:9] + sp2 * I3, J_p1, rp1),
            self._whiten(pre2["cov"][6:9, 6:9] + sp2 * I3
                         + dt2 * dt2 * (R1tR0 @ pre1["cov"][3:6, 3:6]
                                        @ R1tR0.T), J_p2, rp2)]
        Jw = np.vstack([b[0] for b in blocks])
        rw = np.concatenate([b[1] for b in blocks])
        rw_var = np.array([c["gyr_bias_noise"] ** 2] * 3
                          + [c["acc_bias_noise"] ** 2] * 3, d)
        P_b = self.P + np.diag(rw_var) * (dt1 + dt2)
        Lam = np.zeros((9, 9), d)
        Lam[:6, :6] = np.linalg.inv(P_b)
        Lam[6:, 6:] = I3 / d(c["v0_prior_sigma"] ** 2)
        H = Jw.T @ Jw + Lam
        delta = np.linalg.solve(H, Jw.T @ rw)
        dbg = np.clip(delta[0:3], -0.1, 0.1)
        dba = np.clip(delta[3:6], -0.2, 0.2)
        clamped = (np.any(np.abs(delta[0:3]) > 0.1)
                   or np.any(np.abs(delta[3:6]) > 0.2))
        v0 = v0e + delta[6:9]
        v1 = v0 + g * dt1 + R0 @ (pre1["dv"] + pre1["dv_dbg"] @ dbg
                                  + pre1["dv_dba"] @ dba)
        v2 = v1 + g * dt2 + R1 @ (pre2["dv"] + pre2["dv_dbg"] @ dbg
                                  + pre2["dv_dba"] @ dba)
        self.P = P_b if clamped else np.linalg.inv(H)[:6, :6]
        self.R, self.v, self.p = R2, v2, p2
        self.bg, self.ba = self.bg + dbg, self.ba + dba
        self.v0 = v1

    def _diverged(self) -> bool:
        return bool(np.linalg.norm(self.v) > 30.0
                    or np.linalg.norm(self.ba) > 1.0
                    or np.linalg.norm(self.bg) > 1.0)

    # -- a scan --
    def before(self, imu, start: float) -> dict:
        """The chain before scan `start`'s solve: its guess, the body
        velocity for the deskew (None where the program deskews by
        rotation alone), and the lidar-frame gyro window."""
        it, g_l, a_l, valid, k = self.pad(*imu)
        start = float(np.float32(start))
        self._pre = None
        out = {"guess": None, "vel_body": None, "gyro": g_l, "time": it,
               "valid": valid, "start": start, "window": k >= 2}
        if k >= 2 and self.prev_win is not None:
            pre = self.preintegrate(self.prev_win, start)
            dtp = pre["dt"]
            R = self.R @ pre["dR"]
            v = self.v + self.g * dtp + self.R @ pre["dv"]
            p = (self.p + self.v * dtp + 0.5 * self.g * dtp * dtp
                 + self.R @ pre["dp"])
            self._pre = pre
            if self.last is not None:
                out["guess"] = np.concatenate([rot_to_euler(R), p])
                if self.prev_pre is not None:
                    out["vel_body"] = R.T @ v
        self._win = (it, g_l, a_l, valid, start) if k >= 2 else None
        return out

    def after(self, pose) -> None:
        """The refresh from the pose the front end returned."""
        pose = self._f(pose)
        pre = self._pre
        if pre is not None and self.last is not None:
            if self.prev_pre is not None:
                self._update2(self.prev_pre, pre, self.prev_pose, self.last,
                              pose)
            else:
                self._update1(pre, self.last, pose)
                self.v0 = self.v
            self.fail = self.fail or self._diverged()
            self.prev_pre, self.prev_pose = pre, self.last
            if self.n % FAILURE_CHECK_EVERY == 0:
                if self.fail:
                    self._init_state(euler_to_rot(pose[:3]), pose[3:])
                    self.prev_pre = self.prev_pose = None
                    self.v0 = np.zeros(3, self.dt)
                self.fail = False
        else:
            self.R, self.p = euler_to_rot(pose[:3]), pose[3:]
        self.prev_win = self._win
        self.last = pose
        self.n += 1


def run_chain(imu: dict, windows: list, starts: list, poses: list,
              dtype=np.float64) -> list[dict]:
    """Every scan's `Chain.before`, the chain refreshed from `poses` (the
    poses the front end returned, one a scan)."""
    chain = Chain(imu, dtype)
    out = []
    for win, start, pose in zip(windows, starts, poses):
        out.append(chain.before(win, start))
        chain.after(pose)
    return out


def deskew(points, t, valid, step: dict, num: Numerics) -> np.ndarray:
    """The deskewed (P, 3) points of one scan: `points` and their times
    `t` the pretreated cloud, `step` the chain's `before` for the scan."""
    d = num.dtype
    pts, t = num.arr(points), np.asarray(t, d)
    times = np.asarray(step["time"], d) - d(step["start"])
    v_ok = np.asarray(step["valid"])
    prev = np.concatenate([times[:1], times[:-1]])
    dt = np.where(v_ok, times - prev, 0.0).astype(d)
    dt[int(np.argmax(v_ok))] = 0.0
    incr = np.where(v_ok[:, None], np.asarray(step["gyro"], d) * dt[:, None],
                    0.0).astype(d)
    rot = num.arr(np.cumsum(incr, axis=0))
    count = int(v_ok.sum())
    if count < 2 or not step["window"]:
        return np.asarray(points, d)
    tq = np.where(v_ok, times, np.inf)

    def at(tt):
        hi = np.searchsorted(tq, tt, side="right")
        hi = np.minimum(np.maximum(hi, 1), max(count - 1, 0))
        lo = hi - 1
        t_lo, t_hi = tq[lo], tq[hi]
        w = np.clip((tt - t_lo) / np.maximum(t_hi - t_lo, 1e-9), 0.0, 1.0)
        return rot[lo] + w[..., None].astype(d) * (rot[hi] - rot[lo])

    valid = np.asarray(valid, bool)
    t0 = np.min(np.where(valid, t, np.inf))
    R0 = num.arr(euler_to_rot(at(np.array([t0], d))[0]))
    rpy = num.arr(at(t))
    Rs = num.arr(_euler_batch(rpy))
    Rbt = num.einsum("ji,njk->nik", R0, Rs)
    out = num.einsum("nij,nj->ni", Rbt, pts)
    if step["vel_body"] is not None:
        out = num.arr(out + num.arr(step["vel_body"])[None, :]
                      * (t - t0)[:, None].astype(d))
    return np.where(valid[:, None], out, pts)


def _euler_batch(rpy):
    r, p, y = rpy[:, 0], rpy[:, 1], rpy[:, 2]
    cr, sr, cp, sp = np.cos(r), np.sin(r), np.cos(p), np.sin(p)
    cy, sy = np.cos(y), np.sin(y)
    return np.stack([
        np.stack([cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr], -1),
        np.stack([sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr], -1),
        np.stack([-sp, cp * sr, cp * cr], -1)], -2)
