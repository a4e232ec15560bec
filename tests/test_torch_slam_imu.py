"""Port parity of the LIO chain inside SemanticSlam (pipeline/slam.py with
cfg.imu.use_imu) against lis_slam_tpu/pipeline/slam.py.

The sequence is tests/test_round4.py's distorted fixture (the plaza of
tests/_torch_plaza.py, a 10 m circle at 6.3 m/s, 16 x 900 sweeps moving
over each 0.1 s, 24 IMU samples a window, lidar frame) cut to 12 scans,
with an accelerometer window of +400 m/s^2 on scans 7-8 (the stimulus of
tests/test_round4.py's reset test). Configuration: tests/_torch_plaza.py's
tiny_cfgs with use_imu, 64 IMU rows, drain_every 4, the xla GN backend
(the JAX pallas backend in interpret mode returns NaN on LIO) and no
labels. The timestamps come from the IMU clock (no `timestamp`).

One JAX SemanticSlam run serves the module: its FusedState before each
scan (through pipeline/convert.py), each scan's pose, the reset count
after each scan and after finish, and an IMU-rate prediction.

- Each clean scan stepped by the port from the JAX state before it: pose
  within 5e-3 m / 5e-4 rad (the odometry step's bounds), imu.v within
  5e-2 m/s (the JAX chain is float32, the port's float64), bg and ba
  within 1e-3, the two-window flag, the latch and prev_scan_start equal.
- A free-running port run: the same reset count at the same drains, and
  the scan start advancing with the kwarg window as in JAX.
- A window carried by the ScanInput steps as one passed to slam_step.
- predict_imu_rate from a converted state within 1e-4 m.
- The inert-window warning (tests/test_round5.py:195-217) and the IMU
  fields' snapshot round trip.
"""

import dataclasses
import warnings

import numpy as np
import pytest

pytest.importorskip("jax")

import torch

import lis_slam_tpu.io.synthetic as jsyn
from lis_slam_tpu.pipeline import driver as jdriver, slam as jslam
from lis_slam_torch.io import synthetic_torch
from lis_slam_torch.pipeline import convert, driver, slam

from _torch_plaza import tiny_cfgs

N = 12
BAD = (7, 9)  # scans with the +400 m/s^2 accelerometer window
POS_ATOL, ANG_ATOL = 5e-3, 5e-4
V_ATOL = 5e-2  # m/s
BIAS_ATOL = 1e-3
RATE_ATOL = 1e-4  # m
PREDICT_AT = 5  # the nav state after this scan predicts the next window


def cfgs():
    j, t = tiny_cfgs()

    def lio(c):
        return c.replace(
            imu=dataclasses.replace(c.imu, use_imu=True, max_imu_per_scan=64),
            runtime=dataclasses.replace(c.runtime, drain_every=4))
    return lio(j), lio(t)


def _windows():
    """(points, imu_time, gyro, accel) per scan of the distorted fixture."""
    world = synthetic_torch.plaza_world()
    gt = jsyn.circular_trajectory(N + 2, radius=10.0, speed=6.3)
    orig = jsyn.hdl64_elevations
    jsyn.hdl64_elevations = lambda: np.linspace(15.0, -15.0, 16)
    try:
        scans = [jsyn.render_scan(world, gt[i], gt[i + 1], n_scan=16,
                                  horizon=900, seed=300 + i, noise=0.01,
                                  max_range=90.0) for i in range(N + 1)]
    finally:
        jsyn.hdl64_elevations = orig
    out = []
    for i, s in enumerate(scans):
        accel = s.accel + (400.0 if BAD[0] <= i < BAD[1] else 0.0)
        out.append((s.points[s.valid], s.imu_time + i * 0.1, s.gyro, accel))
    return out


@pytest.fixture(scope="module")
def jax_run():
    jcfg, _ = cfgs()
    wins = _windows()
    system = jslam.SemanticSlam(jcfg)
    snaps, poses, resets = [], [], []
    rate = None
    for i, (pts, it, ig, ia) in enumerate(wins[:N]):
        snaps.append(convert.fused_state_to_numpy(system.fstate))
        poses.append(np.asarray(system.process_scan(
            jdriver.pad_scan(pts, jcfg), imu_time=it, imu_gyro=ig,
            imu_accel=ia)))
        resets.append(system.n_imu_resets)
        if i == PREDICT_AT:
            rate = np.asarray(system.predict_imu_rate(*wins[i + 1][1:]))
    snaps.append(convert.fused_state_to_numpy(system.fstate))
    res = system.finish()
    resets.append(system.n_imu_resets)
    return dict(wins=wins, snaps=snaps, poses=np.asarray(poses),
                resets=resets, rate=rate, res=res)


@pytest.fixture(scope="module")
def port_run(jax_run):
    _, tcfg = cfgs()
    system = slam.SemanticSlam(tcfg, device="cpu")
    resets, starts, have_prev = [], [], []
    for pts, it, ig, ia in jax_run["wins"][:N]:
        system.process_scan(driver.pad_scan(pts, tcfg), imu_time=it,
                            imu_gyro=ig, imu_accel=ia)
        resets.append(system.n_imu_resets)
        starts.append(system.fstate.prev_scan_start)
        have_prev.append(system.fstate.imu_have_prev)
    res = system.finish()
    resets.append(system.n_imu_resets)
    return dict(system=system, res=res, resets=resets, starts=starts,
                have_prev=have_prev)


def _window(cfg, win):
    _pts, it, ig, ia = win
    return slam.ImuWindow(*driver.pad_imu_window(cfg, it, ig, ia),
                          float(it[0]))


@pytest.mark.parametrize("i", range(BAD[0] + 1))
def test_fused_step_matches_jax(jax_run, i):
    """Scan i from the JAX state before it (scan 0: the fresh state), up to
    the first violent window."""
    _, tcfg = cfgs()
    snap, after = jax_run["snaps"][i], jax_run["snaps"][i + 1]
    fstate = convert.fused_state_from_numpy(snap)
    win = jax_run["wins"][i]
    fstate2, out = slam.slam_step(fstate, driver.pad_scan(win[0], tcfg),
                                  None, tcfg, "none",
                                  imu_window=_window(tcfg, win))
    p, pj = out.pose.numpy(), jax_run["poses"][i]
    np.testing.assert_allclose(p[3:], pj[3:], atol=POS_ATOL)
    np.testing.assert_allclose(p[:3], pj[:3], atol=ANG_ATOL)
    ja = after["imu"]
    np.testing.assert_allclose(fstate2.imu.v.numpy(), ja["imu"]["v"],
                               atol=V_ATOL)
    np.testing.assert_allclose(fstate2.imu.bg.numpy(), ja["imu"]["bg"],
                               atol=BIAS_ATOL)
    np.testing.assert_allclose(fstate2.imu.ba.numpy(), ja["imu"]["ba"],
                               atol=BIAS_ATOL)
    assert fstate2.imu_have_prev == ja["imu_have_prev"]
    assert fstate2.imu_fail == ja["imu_fail"] == out.imu_fail
    assert fstate2.prev_scan_start == float(ja["prev_scan_start"])
    assert out.imu_win_empty == (i == 0)
    np.testing.assert_array_equal(fstate2.prev_imu_valid.numpy(),
                                  ja["prev_imu_valid"])
    np.testing.assert_allclose(fstate2.odom_pose_host.numpy(), p)


def test_window_carried_by_the_scan(jax_run):
    """Without `imu_window`, slam_step reads the window the ScanInput
    carries (pad_scan's IMU arguments and scan_start), as the JAX step
    reads its scan's: the same step as with the window passed."""
    _, tcfg = cfgs()
    i = 3
    pts, it, ig, ia = jax_run["wins"][i]
    results = []
    for carried in (False, True):
        fstate = convert.fused_state_from_numpy(jax_run["snaps"][i])
        if carried:
            sin = driver.pad_scan(pts, tcfg, imu_time=it, imu_gyro=ig,
                                  imu_accel=ia, scan_start=float(it[0]))
            results.append(slam.slam_step(fstate, sin, None, tcfg, "none"))
        else:
            results.append(slam.slam_step(
                fstate, driver.pad_scan(pts, tcfg), None, tcfg, "none",
                imu_window=_window(tcfg, jax_run["wins"][i])))
    (fa, oa), (fb, ob) = results
    torch.testing.assert_close(ob.pose, oa.pose, rtol=0, atol=0)
    torch.testing.assert_close(fb.imu.v, fa.imu.v, rtol=0, atol=0)
    assert fb.prev_scan_start == fa.prev_scan_start


def test_imu_reset_at_the_same_drain(jax_run, port_run):
    """The latch trips in the violent window and resets when its drain
    window is consumed: after each scan and after finish, the port's reset
    count equals the JAX run's."""
    assert port_run["resets"] == jax_run["resets"]
    assert jax_run["resets"][-1] >= 1
    assert jax_run["resets"][BAD[0]] == 0  # one drain window late
    assert np.isfinite(port_run["res"].poses).all()
    assert port_run["res"].poses.shape == (N, 6)


def test_kwarg_window_advances_scan_start(jax_run, port_run):
    """Windows given through process_scan's kwargs, no timestamp, scans
    padded with scan_start 0: the scan start follows imu_time[0] and the
    two-window update runs."""
    starts = [float(s["imu"]["prev_scan_start"])
              for s in jax_run["snaps"][1:N + 1]]
    assert port_run["starts"] == starts
    assert port_run["starts"][3] > 0.0
    assert all(port_run["have_prev"][1:BAD[0]])


def test_predict_imu_rate_matches_jax(jax_run):
    _, tcfg = cfgs()
    system = slam.SemanticSlam(tcfg, device="cpu")
    system.fstate = convert.fused_state_from_numpy(
        jax_run["snaps"][PREDICT_AT + 1])
    rate = system.predict_imu_rate(*jax_run["wins"][PREDICT_AT + 1][1:])
    want = jax_run["rate"]
    assert rate.shape == want.shape == (24, 6)
    assert rate.dtype == torch.float32
    np.testing.assert_allclose(rate.numpy()[:, 3:], want[:, 3:],
                               atol=RATE_ATOL)
    np.testing.assert_allclose(rate.numpy()[:, :3], want[:, :3], atol=1e-5)
    # the stream starts at the nav state's position
    np.testing.assert_allclose(rate.numpy()[0, 3:],
                               system.fstate.imu.p.numpy(), atol=1e-3)


def test_fused_state_round_trip(jax_run):
    snap = jax_run["snaps"][PREDICT_AT]
    back = convert.fused_state_to_numpy(convert.fused_state_from_numpy(snap))
    for key in ("imu", "prev_pre"):
        for f, a in snap["imu"][key].items():
            np.testing.assert_allclose(back["imu"][key][f], a, rtol=0,
                                       atol=0, err_msg=f"{key}.{f}")
    for f in ("imu_pose0", "imu_v0", "prev_imu_time", "prev_imu_gyro",
              "prev_imu_accel", "prev_imu_valid", "prev_scan_start",
              "imu_have_prev", "imu_fail"):
        np.testing.assert_array_equal(back["imu"][f], snap["imu"][f],
                                      err_msg=f)


def _fab_stepout(win_empty: bool) -> slam.StepOut:
    z6 = torch.zeros(6)
    z = torch.zeros(1)
    return slam.StepOut(
        pose=z6, refined=z6, is_keyframe=False, converged=True,
        degenerate=False, corner_xyz=z, corner_mask=z, surf_xyz=z,
        surf_mask=z, surf_intensity=z, sharp_corner_xyz=z,
        sharp_corner_mask=z, sharp_surf_xyz=z, sharp_surf_mask=z,
        imu_fail=False, imu_win_empty=win_empty)


def test_inert_imu_window_warns():
    """IMU supplied but the clipped window empty on 3 consecutive scans ->
    RuntimeWarning; healthy windows stay silent."""
    _, tcfg = cfgs()
    system = slam.SemanticSlam(tcfg, device="cpu")
    for i in range(1, 4):
        system._pending.append(
            slam._PendingScan(i, i * 0.1, _fab_stepout(True), True))
    with pytest.warns(RuntimeWarning, match="clipped empty"):
        system._drain()
        system.flush_pipeline()
    system2 = slam.SemanticSlam(tcfg, device="cpu")
    for i in range(1, 4):
        system2._pending.append(
            slam._PendingScan(i, i * 0.1, _fab_stepout(False), True))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        system2._drain()
        system2.flush_pipeline()
