"""Port parity of the deskew front end: ops/deskew.py (gyro + positional),
ops/velocity_deskew.py, the IMU padding and velocity stream of
pipeline/driver.py, and the motion-distorted render of
io/synthetic_torch.py, against the JAX package and the numpy renderer.

Tolerances: float32 on both sides, atol 1e-5 on angles, 2e-5 m on
deskewed points (tens of metres); padded buffers equal; the IMU rows of
the render atol 1e-5; the distorted geometry 1e-3 m on 99% of the rays
that hit in both renders (float32 against float64 raycasts).
"""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp
import torch

from lis_slam_tpu.config import SlamConfig as JSlamConfig
from lis_slam_tpu.io import synthetic as jsyn
from lis_slam_tpu.ops import deskew as jdk, velocity_deskew as jvd
from lis_slam_tpu.pipeline import driver as jdriver
from lis_slam_torch.config import SlamConfig
from lis_slam_torch.io import synthetic, synthetic_torch
from lis_slam_torch.ops import deskew as tdk, velocity_deskew as tvd
from lis_slam_torch.pipeline import driver as tdriver

M = 64
VLP16 = np.linspace(15.0, -15.0, 16)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(t, j, atol):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=atol, rtol=0)


def _gyro_window(k, seed=0):
    r = np.random.default_rng(seed)
    it = np.zeros(M, np.float32)
    it[:k] = 12.0 - 0.005 + np.linspace(0.0, 0.11, k)
    ig = np.zeros((M, 3), np.float32)
    ig[:k] = r.normal(0, 0.4, (k, 3))
    return it, ig, np.arange(M) < k


def _points(n=2000, seed=1):
    r = np.random.default_rng(seed)
    pts = r.uniform(-40, 40, (n, 3)).astype(np.float32)
    t = np.sort(r.uniform(0, 0.1, n)).astype(np.float32)
    valid = r.uniform(size=n) > 0.1
    return pts, t, valid


@pytest.mark.parametrize("k", [24, 1])
def test_integrate_gyro_and_rotation_at(k):
    it, ig, iv = _gyro_window(k)
    start = np.float32(12.0)
    ij = jdk.integrate_gyro(jnp.asarray(it), jnp.asarray(ig),
                            jnp.asarray(iv), jnp.float32(start))
    info = tdk.integrate_gyro(_t(it), _t(ig), _t(iv), _t(start))
    np.testing.assert_array_equal(info.times.numpy(), np.asarray(ij.times))
    _close(info.rot_xyz, ij.rot_xyz, 1e-6)
    assert int(info.count) == int(ij.count) == k
    assert bool(info.available) == bool(ij.available) == (k >= 2)
    # query times inside, before and after the window
    q = np.linspace(-0.02, 0.13, 301).astype(np.float32)
    _close(tdk.rotation_at(info, _t(q)), jdk.rotation_at(ij, jnp.asarray(q)),
           1e-5)


@pytest.mark.parametrize("k,vel", [(24, None), (24, [6.0, -0.4, 0.1]),
                                   (1, [6.0, -0.4, 0.1])])
def test_deskew_points(k, vel):
    """Rotation-only, with the positional term, and a window with fewer
    than 2 samples (points pass through unchanged)."""
    it, ig, iv = _gyro_window(k, seed=2)
    pts, t, valid = _points()
    start = np.float32(12.0)
    ij = jdk.integrate_gyro(jnp.asarray(it), jnp.asarray(ig),
                            jnp.asarray(iv), jnp.float32(start))
    info = tdk.integrate_gyro(_t(it), _t(ig), _t(iv), _t(start))
    vj = None if vel is None else jnp.asarray(vel, jnp.float32)
    vt = None if vel is None else _t(np.float32(vel))
    oj = jdk.deskew_points(jnp.asarray(pts), jnp.asarray(t), ij,
                           jnp.asarray(valid), vel_body=vj)
    ot = tdk.deskew_points(_t(pts), _t(t), info, _t(valid), vel_body=vt)
    _close(ot, oj, 2e-5)
    moved = np.linalg.norm(ot.numpy() - pts, axis=1)
    if k < 2:
        np.testing.assert_array_equal(ot.numpy(), pts)
    else:
        assert moved[valid].max() > 0.05
        np.testing.assert_array_equal(ot.numpy()[~valid], pts[~valid])


def test_sync_to_time_and_velocity_deskew():
    st = np.float32([0.0, 1.0, 2.0, 0.0])
    sv = np.float32([[0.0, 1.0], [10.0, 3.0], [20.0, -1.0], [0.0, 0.0]])
    sval = np.array([True, True, True, False])
    for tq in (-0.5, 0.5, 1.25, 2.0, 3.0):
        _close(tvd.sync_to_time(_t(st), _t(sv), _t(sval), np.float32(tq)),
               jvd.sync_to_time(jnp.asarray(st), jnp.asarray(sv),
                                jnp.asarray(sval), jnp.float32(tq)), 1e-6)
    pts, t, valid = _points(seed=3)
    w = np.float32([0.02, -0.05, 0.8])
    v = np.float32([7.5, 0.3, -0.1])
    oj = jvd.velocity_deskew(jnp.asarray(pts), jnp.asarray(t),
                             jnp.asarray(w), jnp.asarray(v),
                             jnp.asarray(valid))
    ot = tvd.velocity_deskew(_t(pts), _t(t), _t(w), _t(v), _t(valid))
    _close(ot, oj, 2e-5)
    np.testing.assert_array_equal(ot.numpy()[~valid], pts[~valid])


def test_pad_imu_window_and_pad_scan():
    jcfg, tcfg = JSlamConfig(), SlamConfig()
    it, ig, _iv = _gyro_window(20)
    ia = np.tile(np.float32([[0.1, 0.2, 9.7]]), (20, 1))
    for accel in (ia, None):
        for a, b in zip(tdriver.pad_imu_window(tcfg, it[:20], ig[:20], accel),
                        jdriver.pad_imu_window(jcfg, it[:20], ig[:20], accel)):
            np.testing.assert_array_equal(a, b)
    pts = np.random.default_rng(4).normal(size=(300, 4)).astype(np.float32)
    kw = dict(imu_time=it[:20], imu_gyro=ig[:20], imu_accel=None,
              scan_start=12.0, velocity=np.float32([1.0, 2.0, 3.0]),
              angular_rate=np.float32([0.1, 0.0, -0.2]))
    sj = jdriver.pad_scan(pts, jcfg, **kw)
    st = tdriver.pad_scan(pts, tcfg, **kw)
    for f in ("points", "valid", "imu_time", "imu_gyro", "imu_valid",
              "imu_accel", "scan_start", "vel", "ang_rate"):
        np.testing.assert_array_equal(getattr(st, f).numpy(),
                                      np.asarray(getattr(sj, f)), err_msg=f)
    assert st.vel_valid == bool(sj.vel_valid)
    # no window and no velocity: the neutral defaults
    st0 = tdriver.pad_scan(pts, tcfg)
    assert st0.imu_time is None and not st0.vel_valid
    assert not bool(jdriver.pad_scan(pts, jcfg).imu_valid.any())


def test_velocity_stream():
    from lis_slam_tpu.imu import preintegration as jpi
    from lis_slam_torch.imu import preintegration as tpi

    cfg = dataclasses.replace(SlamConfig().imu, extrinsic_rot=(
        (0.0, -1.0, 0.0), (1.0, 0.0, 0.0), (0.0, 0.0, 1.0)))
    vj, vt = jdriver.VelocityStream(max_len=3), tdriver.VelocityStream(3)
    assert vt.at(0.5) is None
    for k in range(5):
        twist = tpi.gps_vel_to_lidar([float(k), 0.5, 0.0],
                                     [0.0, 0.0, float(2 * k)], cfg)
        np.testing.assert_allclose(
            twist[0], jpi.gps_vel_to_lidar([float(k), 0.5, 0.0],
                                           [0.0, 0.0, float(2 * k)], cfg)[0])
        vj.push(k * 1.0, *twist)
        vt.push(k * 1.0, *twist)
    for tq in (1.5, 2.0, 2.75, 4.0, 4.5, 0.5):
        a, b = vt.at(tq), vj.at(tq)
        assert (a is None) == (b is None), tq
        if a is not None:
            np.testing.assert_array_equal(a[0], b[0])
            np.testing.assert_array_equal(a[1], b[1])


def test_distorted_render_matches_numpy():
    """The on-device render of a VLP-16 sweep moving 0.8 m: the IMU rows
    equal the numpy render_scan's, and the noise-free points land where
    the numpy raycast puts them."""
    world = synthetic.make_world(seed=5)
    gt = synthetic.circular_trajectory(3, radius=60.0, speed=8.0)
    H = 360
    orig = jsyn.hdl64_elevations
    jsyn.hdl64_elevations = lambda: VLP16
    try:
        ref = jsyn.render_scan(world, gt[1], gt[2], n_scan=16, horizon=H,
                               noise=0.0, seed=0)
    finally:
        jsyn.hdl64_elevations = orig
    gyro, accel, imu_t = synthetic_torch.imu_rows(gt[1], gt[2])
    np.testing.assert_allclose(gyro, ref.gyro, atol=1e-5)
    np.testing.assert_allclose(accel, ref.accel, atol=1e-5)
    np.testing.assert_array_equal(imu_t, ref.imu_time)
    assert abs(gyro[0, 2] - 8.0 / 60.0) < 1e-3  # yaw rate speed / radius

    tw = synthetic_torch.to_device_world(world, "cpu")
    pts, _lbl, valid = synthetic_torch.render_scan_device(
        tw, _t(gt[1]), None, n_scan=16, horizon=H, noise=0.0,
        next_pose6=_t(gt[2]), elevations=VLP16)
    both = valid.numpy() & ref.valid
    assert both.sum() > 0.95 * ref.valid.sum() > 3000
    err = np.linalg.norm(pts.numpy()[both, :3] - ref.points[both, :3], axis=1)
    assert np.quantile(err, 0.99) < 1e-3
    # without the motion, the second half of the sweep lands elsewhere
    still, _l, v2 = synthetic_torch.render_scan_device(
        tw, _t(gt[1]), None, n_scan=16, horizon=H, noise=0.0,
        elevations=VLP16)
    late = both & v2.numpy() & (np.arange(16 * H) % H > H // 2)
    shift = np.linalg.norm(still.numpy()[late, :3] - pts.numpy()[late, :3],
                           axis=1)
    assert np.median(shift) > 0.1
