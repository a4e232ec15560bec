"""Port parity of the LiDAR-inertial slice: pipeline/lio.py LioOdometry
(gyro + positional deskew, IMU preintegrated guess, the one- and
two-window velocity/bias refresh, the failure latch) against the JAX
package's LioOdometry.

The sequence is the one tests/test_lio.py tracks: a ring of buildings and
poles, a 10 m-radius circle at 6.3 m/s, VLP-16 sweeps (16 beams, here 450
columns) motion-distorted over each 0.1 s sweep, 24 IMU samples per
window, pre-rotated by extrinsic_rot^T so imu_to_lidar recovers the lidar
frame. (The city world of make_world gives a 450-column VLP-16 too few
constraints along the street: the JAX run itself does not track there.)

One JAX trajectory serves the module. The port takes over from the JAX
run's state after START scans, carried across with pipeline/convert.py
(odometry state, IMU state, window pair, velocity, latch), and then runs
on its own state. Per scan: keyframe flags equal, positions within 5e-3 m
and angles within 5e-4 rad (the odometry step's bounds); the IMU state's
v within 5e-2 m/s (position differences over 0.1 s windows, and the JAX
chain runs in float32 against the port's float64), bg and ba within 1e-3.
"""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")

import torch

import lis_slam_tpu.io.synthetic as jsyn
from lis_slam_tpu.config import lio_config as jlio_config
from lis_slam_tpu.pipeline import lio as jlio
from lis_slam_tpu.pipeline import trajectory as jtraj
from lis_slam_torch.config import lio_config
from lis_slam_torch.pipeline import convert, lio, trajectory

H = 450
N_SCANS = 10
START = 4
POS_ATOL = 5e-3  # m
ANG_ATOL = 5e-4  # rad
V_ATOL = 5e-2  # m/s
BIAS_ATOL = 1e-3  # rad/s and m/s^2


def _cfgs():
    def cut(c):
        return c.replace(sensor=dataclasses.replace(
            c.sensor, horizon_scan=H, max_raw_points=16 * H))
    return cut(jlio_config()), cut(lio_config())


def _ring_world():
    """The world of tests/test_lio.py."""
    rng = np.random.default_rng(9)
    boxes = []
    for k in range(14):
        ang = 2 * np.pi * k / 14
        cx, cy = 26.0 * np.cos(ang), 10.0 + 26.0 * np.sin(ang)
        w, d, h = rng.uniform(5, 9), rng.uniform(5, 9), rng.uniform(5, 14)
        boxes.append([cx - w / 2, cy - d / 2, 0, cx + w / 2, cy + d / 2, h])
    poles = [[r * np.cos(a), 10.0 + r * np.sin(a), 0.15, 5.0]
             for a, r in zip(np.linspace(0, 2 * np.pi, 24),
                             rng.uniform(15, 20, 24))]
    return jsyn.World(boxes=np.asarray(boxes),
                      box_labels=np.full(14, jsyn.LBL_BUILDING, np.int32),
                      poles=np.asarray(poles))


def _jax_snapshot(j) -> dict:
    """convert.lio_from_numpy's layout, from the JAX LioOdometry."""
    def nt(x):
        return None if x is None else {f: np.asarray(v)
                                       for f, v in x._asdict().items()}

    def arr(x):
        return None if x is None else np.asarray(x)

    win = j._prev_win
    return dict(state=nt(j.state), imu_state=nt(j.imu_state),
                prev_pre=nt(j._prev_pre), prev_pose6=arr(j._prev_pose6),
                v0=arr(j._v0), last_pose6=arr(j._last_pose6),
                prev_win=None if win is None else tuple(
                    np.asarray(x) for x in win),
                fail_acc=bool(j._fail_acc), n_resets=j.diag.n_resets,
                n_scans=j.diag.n_scans)


@pytest.fixture(scope="module")
def jax_lio():
    jcfg, _ = _cfgs()
    world = _ring_world()
    gt = jsyn.circular_trajectory(N_SCANS + 2, radius=10.0, speed=6.3)
    orig = jsyn.hdl64_elevations
    jsyn.hdl64_elevations = lambda: np.linspace(15.0, -15.0, 16)
    try:
        scans = [jsyn.render_scan(world, gt[i], gt[i + 1], n_scan=16,
                                  horizon=H, seed=300 + i, max_range=90.0)
                 for i in range(N_SCANS + 1)]
    finally:
        jsyn.hdl64_elevations = orig
    R_ext = np.asarray(jcfg.imu.extrinsic_rot, np.float64)
    args = [(s.points[s.valid], s.imu_time + i * 0.1,
             (s.gyro @ R_ext).astype(np.float32),
             (s.accel @ R_ext).astype(np.float32), i * 0.1)
            for i, s in enumerate(scans)]
    j = jlio.LioOdometry(jcfg)
    snaps, poses, imu = [], [], []
    for a in args[:N_SCANS]:
        snaps.append(_jax_snapshot(j))
        poses.append(np.asarray(j.process_scan(*a)))
        imu.append((int(j.state.kf_count), np.asarray(j.imu_state.v),
                    np.asarray(j.imu_state.bg), np.asarray(j.imu_state.ba)))
    rate = np.asarray(j.predict_imu_rate(*args[N_SCANS][1:4]))
    assert j.diag.n_resets == 0
    return dict(args=args, snaps=snaps, poses=np.asarray(poses), imu=imu,
                gt=gt, end=_jax_snapshot(j), rate=rate)


def test_lio_matches_jax_from_same_state(jax_lio):
    _, tcfg = _cfgs()
    system = convert.lio_from_numpy(jax_lio["snaps"][START], tcfg)
    n_kf = 0
    for i in range(START, N_SCANS):
        kf_before = int(system.state.kf_count)
        p = system.process_scan(*jax_lio["args"][i]).numpy()
        kf_j, v, bg, ba = jax_lio["imu"][i]
        is_kf = int(system.state.kf_count) > kf_before
        assert is_kf == (kf_j > jax_lio["imu"][i - 1][0]), f"scan {i}"
        n_kf += is_kf
        pj = jax_lio["poses"][i]
        np.testing.assert_allclose(p[3:], pj[3:], atol=POS_ATOL,
                                   err_msg=f"scan {i}")
        np.testing.assert_allclose(p[:3], pj[:3], atol=ANG_ATOL,
                                   err_msg=f"scan {i}")
        s = system.imu_state
        np.testing.assert_allclose(s.v.numpy(), v, atol=V_ATOL,
                                   err_msg=f"scan {i}")
        np.testing.assert_allclose(s.bg.numpy(), bg, atol=BIAS_ATOL)
        np.testing.assert_allclose(s.ba.numpy(), ba, atol=BIAS_ATOL)
    assert n_kf >= 1
    assert system.diag.n_resets == 0 and system.diag.n_scans == N_SCANS
    # the two-window solve ran: the velocity estimate at pose0 is live
    assert system._prev_pre is not None and system.imu_state.v.norm() > 3.0


def test_lio_snapshot_round_trip(jax_lio):
    _, tcfg = _cfgs()
    snap = jax_lio["end"]
    back = convert.lio_to_numpy(convert.lio_from_numpy(snap, tcfg))
    for f, a in snap["state"].items():
        assert back["state"][f].dtype == a.dtype, f
        np.testing.assert_array_equal(back["state"][f], a, err_msg=f)
    for key in ("imu_state", "prev_pre"):
        for f, a in snap[key].items():
            np.testing.assert_allclose(back[key][f], a, rtol=0, atol=0,
                                       err_msg=f"{key}.{f}")
    for w_back, w in zip(back["prev_win"], snap["prev_win"]):
        np.testing.assert_array_equal(np.asarray(w_back, np.asarray(w).dtype),
                                      w)
    for f in ("prev_pose6", "v0", "last_pose6"):
        np.testing.assert_allclose(back[f], snap[f], rtol=0, atol=0)
    assert (back["fail_acc"], back["n_resets"], back["n_scans"]) == (
        snap["fail_acc"], snap["n_resets"], snap["n_scans"])


def test_predict_imu_rate_matches_jax(jax_lio):
    """IMU-rate poses over the next window from the same nav state."""
    _, tcfg = _cfgs()
    system = convert.lio_from_numpy(jax_lio["end"], tcfg)
    rate = system.predict_imu_rate(*jax_lio["args"][N_SCANS][1:4])
    assert rate.shape == (24, 6) and rate.dtype == torch.float32
    np.testing.assert_allclose(rate.numpy()[:, 3:], jax_lio["rate"][:, 3:],
                               atol=1e-4)
    np.testing.assert_allclose(rate.numpy()[:, :3], jax_lio["rate"][:, :3],
                               atol=1e-5)


def test_lio_replay_from_first_scan(jax_lio):
    """The port's own run from a fresh LioOdometry: the bootstrap branches
    (no previous window, the one-window refresh, the first two-window
    solve) and tracking within the JAX run's ATE."""
    _, tcfg = _cfgs()
    system = lio.LioOdometry(tcfg, device="cpu")
    poses = np.asarray([system.process_scan(*a).numpy()
                        for a in jax_lio["args"][:N_SCANS]])
    gt_rel = trajectory.relative_to_first(jax_lio["gt"][:N_SCANS])
    ate = trajectory.ate_rmse(poses, gt_rel, align=False)
    ate_j = jtraj.ate_rmse(jax_lio["poses"], gt_rel, align=False)
    assert np.isfinite(poses).all() and system.diag.n_resets == 0
    assert ate <= 1.5 * ate_j + 0.02, (ate, ate_j)
    assert system.diag.imu_s > 0.0
