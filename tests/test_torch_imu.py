"""Port parity of imu/preintegration.py: the same seeded windows and poses
go through the JAX package (float32, as it runs) and the port (float64 on
the host, as pipeline/lio.py runs it).

Tolerances are float32 rounding of the JAX side: rotations, Jacobians and
positions atol 2e-6, velocities atol 2e-5, covariances rtol 1e-4; the
bias/velocity solves atol 1e-4 on velocities and 1e-5 on biases (their
whitened normal equations amplify float32 residual rounding).
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp
import torch

from lis_slam_tpu.config import ImuConfig as JImuConfig
from lis_slam_tpu.imu import preintegration as jpi
from lis_slam_tpu.utils import se3 as jse3
from lis_slam_torch.config import ImuConfig
from lis_slam_torch.imu import preintegration as tpi

CFG_J, CFG_T = JImuConfig(use_imu=True), ImuConfig(use_imu=True)
M = 64


def _h(x):
    return torch.from_numpy(np.asarray(x, np.float64))


def _window(seed, k=24, t_start=3.0):
    """A padded window: k valid samples over 0.11 s at ~210 Hz."""
    r = np.random.default_rng(seed)
    t = np.zeros(M, np.float32)
    t[:k] = t_start - 0.005 + np.linspace(0.0, 0.11, k)
    gyro = np.zeros((M, 3), np.float32)
    gyro[:k] = (0.3 * np.sin(np.linspace(0, 3, k))[:, None]
                * np.array([[1.0, -0.5, 0.8]]) + 0.01 * r.normal(size=(k, 3)))
    accel = np.zeros((M, 3), np.float32)
    accel[:, 2] = 9.80511
    accel[:k] = np.array([[0.5, -0.2, 9.9]]) + 0.1 * r.normal(size=(k, 3))
    valid = np.arange(M) < k
    bg = (0.01 * r.normal(size=3)).astype(np.float32)
    ba = (0.05 * r.normal(size=3)).astype(np.float32)
    return t, gyro, accel, valid, bg, ba


def _pre_pair(w, t0=None, t1=None):
    t, gyro, accel, valid, bg, ba = w
    pj = jpi.preintegrate(
        jnp.asarray(t), jnp.asarray(gyro), jnp.asarray(accel),
        jnp.asarray(valid), jnp.asarray(bg), jnp.asarray(ba), CFG_J,
        t0=None if t0 is None else jnp.float32(t0),
        t1=None if t1 is None else jnp.float32(t1))
    pt = tpi.preintegrate(_h(t), _h(gyro), _h(accel), torch.from_numpy(valid),
                          _h(bg), _h(ba), CFG_T, t0=t0, t1=t1)
    return pj, pt


def _close(t, j, atol, rtol=0.0):
    np.testing.assert_allclose(t.numpy(), np.asarray(j, np.float64),
                               atol=atol, rtol=rtol)


def _check_pre(pt, pj):
    assert pt.count == int(pj.count)
    _close(pt.delta_t, pj.delta_t, 1e-7)
    for f in ("delta_R", "delta_p", "dR_dbg", "dv_dba", "dp_dbg", "dp_dba"):
        _close(getattr(pt, f), getattr(pj, f), 2e-6)
    for f in ("delta_v", "dv_dbg"):
        _close(getattr(pt, f), getattr(pj, f), 2e-5)
    _close(pt.cov, pj.cov, 1e-12, rtol=1e-4)


@pytest.mark.parametrize("clip", [False, True])
def test_preintegrate_matches(clip):
    """Unclipped over the whole padded window, and clipped to the 0.1 s
    pose interval inside it (boundary segments truncated)."""
    w = _window(1)
    t0, t1 = (float(np.float32(3.0)), float(np.float32(3.1))) if clip \
        else (None, None)
    pj, pt = _pre_pair(w, t0, t1)
    _check_pre(pt, pj)
    assert pt.count == (21 if clip else 23)
    assert abs(float(pt.delta_t) - (0.1 if clip else 0.11)) < 1e-6


def test_preintegrate_sparse_window():
    """Invalid samples in the middle of the window and fewer than two
    valid samples."""
    t, gyro, accel, valid, bg, ba = _window(2)
    valid = valid.copy()
    valid[3:7] = False
    _check_pre(*reversed(_pre_pair((t, gyro, accel, valid, bg, ba))))
    one = np.arange(M) < 1
    pj, pt = _pre_pair((t, gyro, accel, one, bg, ba))
    _check_pre(pt, pj)
    assert pt.count == 0
    np.testing.assert_array_equal(pt.delta_R.numpy(), np.eye(3))


def _states(seed):
    r = np.random.default_rng(seed)
    rpy = r.uniform(-0.3, 0.3, 3)
    R = np.asarray(jse3.euler_to_rot(jnp.asarray(rpy, jnp.float32)))
    v = r.normal(size=3).astype(np.float32)
    p = r.normal(size=3).astype(np.float32)
    bg = (0.01 * r.normal(size=3)).astype(np.float32)
    ba = (0.05 * r.normal(size=3)).astype(np.float32)
    P = np.diag(r.uniform(0.001, 0.01, 6)).astype(np.float32)
    P[0, 3] = P[3, 0] = 0.0005
    sj = jpi.ImuState(R=jnp.asarray(R), v=jnp.asarray(v), p=jnp.asarray(p),
                      bg=jnp.asarray(bg), ba=jnp.asarray(ba),
                      P_bias=jnp.asarray(P))
    st = tpi.ImuState(R=_h(R), v=_h(v), p=_h(p), bg=_h(bg), ba=_h(ba),
                      P_bias=_h(P))
    return sj, st


def test_predict_correct_delta_predict_path():
    w = _window(3)
    pj, pt = _pre_pair(w)
    sj, st = _states(3)
    oj = jpi.predict(sj, pj, CFG_J.gravity)
    ot = tpi.predict(st, pt, CFG_T.gravity)
    _close(ot.R, oj.R, 2e-6)
    _close(ot.v, oj.v, 2e-5)
    _close(ot.p, oj.p, 2e-5)
    dbg = np.float32([0.004, -0.003, 0.002])
    dba = np.float32([0.02, 0.01, -0.015])
    for a, b, tol in zip(tpi.correct_delta(pt, _h(dbg), _h(dba)),
                         jpi.correct_delta(pj, jnp.asarray(dbg),
                                           jnp.asarray(dba)),
                         (2e-6, 2e-5, 2e-6)):
        _close(a, b, tol)
    t, gyro, accel, valid, _bg, _ba = w
    Rj, vj, pj_ = jpi.predict_path(jnp.asarray(t), jnp.asarray(gyro),
                                   jnp.asarray(accel), jnp.asarray(valid), sj,
                                   CFG_J)
    Rt, vt, pt_ = tpi.predict_path(_h(t), _h(gyro), _h(accel),
                                   torch.from_numpy(valid), st, CFG_T)
    assert Rt.shape == (M, 3, 3) and pt_.shape == (M, 3)
    _close(Rt, Rj, 2e-6)
    _close(vt, vj, 2e-5)
    _close(pt_, pj_, 2e-5)


def _poses(seed, pre_pairs, sj, st, err):
    """Lidar pose anchors consistent with the nav state and the windows,
    perturbed by `err` (rotation, position)."""
    r = np.random.default_rng(seed)
    poses = []
    s = sj
    for pj, _pt in [(None, None)] + pre_pairs:
        if pj is not None:
            s = jpi.predict(s, pj, CFG_J.gravity)
        pose = np.concatenate([np.asarray(jse3.rot_to_euler(s.R)),
                               np.asarray(s.p)])
        pose[:3] += r.normal(0, err[0], 3)
        pose[3:] += r.normal(0, err[1], 3)
        poses.append(pose.astype(np.float32))
    return poses


def test_velocity_bias_update():
    w = _window(4)
    pj, pt = _pre_pair(w)
    sj, st = _states(4)
    p0, p1 = _poses(4, [(pj, pt)], sj, st, (0.004, 0.01))
    oj = jpi.velocity_bias_update(sj, pj, jnp.asarray(p0), jnp.asarray(p1),
                                  CFG_J)
    ot = tpi.velocity_bias_update(st, pt, _h(p0), _h(p1), CFG_T)
    _close(ot.v, oj.v, 1e-4)
    _close(ot.bg, oj.bg, 1e-5)
    _close(ot.ba, oj.ba, 0)
    _close(ot.R, oj.R, 2e-6)
    _close(ot.P_bias, oj.P_bias, 1e-9, rtol=1e-3)
    # the bg-ba cross blocks are dropped
    assert not ot.P_bias[:3, 3:].any() and not ot.P_bias[3:, :3].any()


@pytest.mark.parametrize("branch", ["free", "clamped"])
def test_velocity_bias_update2(branch):
    """The two-window (bg, ba, v0) solve; "clamped" anchors the poses far
    from the IMU so a safety clamp cuts the step, and the marginal must
    then stay the random-walk-inflated prior."""
    pre1 = _pre_pair(_window(5, t_start=3.0))
    pre2 = _pre_pair(_window(6, t_start=3.11))
    sj, st = _states(5)
    err = (0.004, 0.01) if branch == "free" else (0.3, 0.5)
    p0, p1, p2 = _poses(5, [pre1, pre2], sj, st, err)
    v0 = np.asarray(sj.v) + np.float32([0.05, -0.02, 0.01])
    oj, v1j = jpi.velocity_bias_update2(
        sj, pre1[0], pre2[0], *(jnp.asarray(p) for p in (p0, p1, p2)),
        jnp.asarray(v0), CFG_J)
    ot, v1t = tpi.velocity_bias_update2(
        st, pre1[1], pre2[1], *(_h(p) for p in (p0, p1, p2)), _h(v0), CFG_T)
    for a, b in ((ot.v, oj.v), (v1t, v1j)):
        _close(a, b, 1e-4)
    _close(ot.bg, oj.bg, 1e-5)
    _close(ot.ba, oj.ba, 1e-5)
    _close(ot.R, oj.R, 2e-6)
    _close(ot.p, oj.p, 0)
    _close(ot.P_bias, oj.P_bias, 1e-9, rtol=1e-3)
    dt = float(pre1[1].delta_t + pre2[1].delta_t)
    inflated = st.P_bias.numpy() + np.diag(
        [CFG_T.gyr_bias_noise**2] * 3 + [CFG_T.acc_bias_noise**2] * 3) * dt
    assert np.allclose(ot.P_bias.numpy(), inflated) == (branch == "clamped")


def test_failure_detection():
    cases = [(np.zeros(3), np.zeros(3), np.zeros(3)),
             (np.float32([40.0, 0, 0]), np.zeros(3), np.zeros(3)),
             (np.zeros(3), np.float32([1.2, 0, 0]), np.zeros(3)),
             (np.zeros(3), np.zeros(3), np.float32([0.0, -1.1, 0]))]
    for v, bg, ba in cases:
        assert bool(tpi.failure_detection(_h(v), _h(bg), _h(ba))) == bool(
            jpi.failure_detection(jnp.asarray(v), jnp.asarray(bg),
                                  jnp.asarray(ba)))


def test_frame_conversions():
    """imu_to_lidar (tensors), gps_vel_to_lidar and remap_imu_orientation
    (numpy) against the JAX package."""
    r = np.random.default_rng(7)
    g = r.normal(size=(8, 3)).astype(np.float32)
    a = r.normal(size=(8, 3)).astype(np.float32)
    for x, y in zip(tpi.imu_to_lidar(_h(g), _h(a), CFG_T),
                    jpi.imu_to_lidar(jnp.asarray(g), jnp.asarray(a), CFG_J)):
        _close(x, y, 2e-6)
    lin, ang = r.normal(size=3), r.normal(size=3)
    for x, y in zip(tpi.gps_vel_to_lidar(lin, ang, CFG_T),
                    jpi.gps_vel_to_lidar(lin, ang, CFG_J)):
        np.testing.assert_allclose(x, y, atol=1e-12)
    rpy = r.uniform(-0.5, 0.5, 3)
    np.testing.assert_allclose(tpi.remap_imu_orientation(rpy, CFG_T),
                               jpi.remap_imu_orientation(rpy, CFG_J),
                               atol=1e-12)
