"""Port parity of the whole slice: the front-end odometry step.

Both packages replay the same rendered HDL-64 scans (450 of 1800 columns)
with the default KITTI configuration. The port starts from the JAX state
after a few scans, carried across with pipeline/convert.py, so the map and
the pose are identical when the comparison begins; from there each package
runs on its own state. Keyframe flags must be equal, per-scan positions
within 5e-3 m and angles within 5e-4 rad.

One JAX trajectory serves the module: the JAX step costs about a minute of
CPU compile.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp
import torch

import lis_slam_torch
from lis_slam_tpu.config import SensorConfig as JSensorConfig
from lis_slam_tpu.config import SlamConfig as JSlamConfig
from lis_slam_tpu.io import synthetic
from lis_slam_tpu.ops import pretreatment as jpre
from lis_slam_tpu.pipeline import driver as jdriver, odometry as jodo
from lis_slam_tpu.pipeline import trajectory as jtraj
from lis_slam_torch.config import SensorConfig, SlamConfig
from lis_slam_torch.pipeline import convert, driver, odometry, trajectory
from lis_slam_torch.utils import se3_np

H = 450
N_SCANS = 8
START = 4  # the port takes over from the JAX state after this many scans
POS_ATOL = 5e-3  # m
ANG_ATOL = 5e-4  # rad


def _cfgs():
    sensor = dict(horizon_scan=H, max_raw_points=64 * H)
    return (JSlamConfig().replace(sensor=JSensorConfig(**sensor)),
            SlamConfig().replace(sensor=SensorConfig(**sensor)))


@pytest.fixture(scope="module")
def jax_run():
    jcfg, _ = _cfgs()
    world = synthetic.make_world(seed=5)
    gt = synthetic.circular_trajectory(N_SCANS + 1, radius=60.0, speed=8.0)
    clouds = [synthetic.render_scan(world, gt[i], None, horizon=H,
                                    seed=50 + i).points
              for i in range(N_SCANS)]
    clouds = [c[np.linalg.norm(c[:, :3], axis=1) > 0] for c in clouds]
    state = jodo.init_state(jcfg)
    states, outs = [], []
    for c in clouds:
        states.append({f: np.asarray(v) for f, v in state._asdict().items()})
        state, out = jodo.odom_step_nodonate(state, jdriver.pad_scan(c, jcfg),
                                             jcfg)
        outs.append(out)
    return clouds, states, outs, gt


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_odom_step_matches_jax(jax_run, backend):
    clouds, states, outs, _gt = jax_run
    _, tcfg = _cfgs()
    tcfg = tcfg.replace(matching=dataclasses.replace(tcfg.matching,
                                                     gn_backend=backend))
    state = convert.odom_state_from_numpy(states[START])
    n_kf = 0
    for i in range(START, N_SCANS):
        state, out = odometry.odom_step(
            state, driver.pad_scan(clouds[i], tcfg), tcfg)
        ref = outs[i]
        assert out.is_keyframe == bool(ref.is_keyframe), f"scan {i}"
        n_kf += out.is_keyframe
        p, pj = out.pose.numpy(), np.asarray(ref.pose)
        np.testing.assert_allclose(p[3:], pj[3:], atol=POS_ATOL,
                                   err_msg=f"scan {i}")
        np.testing.assert_allclose(p[:3], pj[:3], atol=ANG_ATOL,
                                   err_msg=f"scan {i}")
        assert out.n_valid > 200 and out.iterations >= 1
        assert abs(out.n_valid - int(ref.n_valid)) <= 0.05 * out.n_valid
    assert n_kf >= 1  # the map update ran inside the compared window
    # the carried state continues the JAX one: same ring bookkeeping
    ends = convert.odom_state_to_numpy(state)
    assert int(ends["frame_idx"]) == N_SCANS


def test_external_guess_and_imu_attitude_match_jax(jax_run):
    """The initial-guess cascade with an external guess, and the IMU
    roll/pitch slerp, against the JAX step from the same state."""
    clouds, states, outs, _gt = jax_run
    jcfg, tcfg = _cfgs()
    guess = np.asarray(outs[START].pose) + np.float32(
        [0.002, -0.001, 0.003, 0.05, -0.04, 0.01])
    rpy = np.asarray(outs[START].pose)[:3] + np.float32([0.01, -0.008, 0.0])
    sin_j = jdriver.pad_scan(clouds[START], jcfg)._replace(
        init_guess=jnp.asarray(guess), init_guess_valid=jnp.bool_(True),
        imu_rpy=jnp.asarray(rpy), imu_rpy_valid=jnp.bool_(True))
    state_j = jodo.OdomState(**{f: jnp.asarray(v)
                                for f, v in states[START].items()})
    _, out_j = jodo.odom_step_nodonate(state_j, sin_j, jcfg)
    sin_t = driver.pad_scan(clouds[START], tcfg)._replace(
        init_guess=torch.from_numpy(guess), init_guess_valid=True,
        imu_rpy=torch.from_numpy(rpy), imu_rpy_valid=True)
    _, out_t = odometry.odom_step(
        convert.odom_state_from_numpy(states[START]), sin_t, tcfg)
    assert out_t.is_keyframe == bool(out_j.is_keyframe)
    p, pj = out_t.pose.numpy(), np.asarray(out_j.pose)
    np.testing.assert_allclose(p[3:], pj[3:], atol=POS_ATOL)
    np.testing.assert_allclose(p[:3], pj[:3], atol=ANG_ATOL)
    # the slerp moved roll and pitch toward the IMU attitude
    assert abs(p[0] - np.asarray(outs[START].pose)[0]) > 1e-6


def test_replay_tracks_ground_truth(jax_run):
    """The port's own replay from a fresh state, through the driver."""
    clouds, _s, outs, gt = jax_run
    _, tcfg = _cfgs()
    res = driver.replay_odometry(clouds, tcfg, warmup=2, device="cpu")
    gt_rel = trajectory.relative_to_first(gt[:N_SCANS])
    assert res.poses.shape == (N_SCANS, 6)
    assert trajectory.ate_rmse(res.poses, gt_rel, align=False) < 0.1
    assert trajectory.rpe(res.poses, gt_rel)[0] < 0.1
    ref = np.asarray([np.asarray(o.pose) for o in outs])
    assert trajectory.ate_rmse(ref, gt_rel, align=False) < 0.1
    assert res.scans_per_sec > 0 and res.keyframes[0]


def test_state_conversion_round_trip(jax_run):
    assert odometry.OdomState._fields == jodo.OdomState._fields
    arrays = jax_run[1][START]
    back = convert.odom_state_to_numpy(convert.odom_state_from_numpy(arrays))
    for f in odometry.OdomState._fields:
        assert back[f].dtype == arrays[f].dtype, f
        np.testing.assert_array_equal(back[f], arrays[f], err_msg=f)


def test_unported_paths_raise(jax_run):
    """Formerly the check that the IMU configurations raised; they are
    ported now. From the same state, one motion-distorted scan through the
    gyro deskew (use_imu, with the positional term) and through the
    velocity front end (deskew_mode="velocity") must match the JAX step."""
    _clouds, states, _outs, gt = jax_run
    jcfg, tcfg = _cfgs()
    s = synthetic.render_scan(synthetic.make_world(seed=5), gt[START],
                              gt[START + 1], horizon=H, seed=50 + START)
    cloud = s.points[s.valid]
    start = 2.0
    R0 = se3_np.pose_to_matrix(gt[START])[:3, :3]
    vel = (R0.T @ (gt[START + 1][3:] - gt[START][3:]) / 0.1).astype(
        np.float32)
    for imu, kw, extra in (
            (dict(use_imu=True),
             dict(imu_time=s.imu_time + start, imu_gyro=s.gyro,
                  scan_start=start),
             dict(deskew_vel=vel)),
            (dict(deskew_mode="velocity"),
             dict(velocity=vel, angular_rate=s.gyro[0]), {})):
        jc, tc = (c.replace(imu=dataclasses.replace(c.imu, **imu))
                  for c in (jcfg, tcfg))
        sin_j = jdriver.pad_scan(cloud, jc, **kw)._replace(
            **{k: jnp.asarray(v) for k, v in extra.items()})
        state_j = jodo.OdomState(**{f: jnp.asarray(v)
                                    for f, v in states[START].items()})
        _, out_j = jodo.odom_step_nodonate(state_j, sin_j, jc)
        sin_t = driver.pad_scan(cloud, tc, **kw)._replace(
            **{k: torch.from_numpy(v) for k, v in extra.items()})
        _, out_t = odometry.odom_step(
            convert.odom_state_from_numpy(states[START]), sin_t, tc)
        assert out_t.is_keyframe == bool(out_j.is_keyframe), imu
        p, pj = out_t.pose.numpy(), np.asarray(out_j.pose)
        np.testing.assert_allclose(p[3:], pj[3:], atol=POS_ATOL, err_msg=imu)
        np.testing.assert_allclose(p[:3], pj[:3], atol=ANG_ATOL, err_msg=imu)
        # the deskew moved the points: the features differ from no deskew
        fc = odometry.preprocess(sin_t, tc)
        fc0 = odometry.preprocess(sin_t, tcfg)
        assert not torch.equal(fc.surf_xyz, fc0.surf_xyz), imu


def test_compact_scan_matches_bench_prep():
    """driver.compact_scan against the JAX bench's loader step, spelled out
    here as bench.py runs it."""
    jcfg, tcfg = _cfgs()
    s = synthetic.render_scan(synthetic.make_world(seed=5),
                              synthetic.circular_trajectory(2)[0], None,
                              horizon=H, seed=3)
    cap = 8192
    ring, ok = jpre.compute_ring(jnp.asarray(s.points), jnp.asarray(s.valid),
                                 jcfg.sensor.n_scan)
    keep = np.asarray(ok & (ring % jcfg.sensor.downsample_rate == 0))
    kept = s.points[keep][:cap]
    sin = driver.compact_scan(torch.from_numpy(s.points),
                              torch.from_numpy(s.valid), tcfg, capacity=cap)
    n = len(kept)
    assert int(sin.valid.sum()) == n and bool(sin.valid[:n].all())
    np.testing.assert_array_equal(sin.points[:n].numpy(), kept)
    assert not sin.points[n:].any()


def test_trajectory_metrics_match():
    r = np.random.default_rng(4)
    est = np.concatenate([r.uniform(-0.3, 0.3, (20, 3)),
                          np.cumsum(r.normal(0, 1, (20, 3)), 0)], 1)
    gt = est + r.normal(0, 0.02, est.shape)
    np.testing.assert_allclose(trajectory.relative_to_first(est),
                               jtraj.relative_to_first(est), atol=1e-4)
    for align in (False, True):
        assert trajectory.ate_rmse(est, gt, align) == pytest.approx(
            jtraj.ate_rmse(est, gt, align), rel=1e-6)
    np.testing.assert_allclose(trajectory.rpe(est, gt), jtraj.rpe(est, gt),
                               rtol=1e-3, atol=1e-4)


_HYGIENE = """
import sys
sys.modules["jax"] = None  # any import of JAX now raises
import numpy as np
import lis_slam_torch
from lis_slam_torch import config, labels
from lis_slam_torch.io import synthetic, synthetic_torch
from lis_slam_torch.graph import pose_graph
from lis_slam_torch.imu import preintegration
from lis_slam_torch.loop import epsc
from lis_slam_torch.mapping import submap
from lis_slam_torch.ops import (cuda_build, deskew, features, gn_cuda,
                                gn_solve, icp, knn, knn_cuda, pretreatment,
                                projection, scan_match, velocity_deskew, voxel)
from lis_slam_torch.parallel import batched
from lis_slam_torch.pipeline import (convert, driver, lio, odometry,
                                     semantic_odometry, slam, trajectory)
from lis_slam_torch.utils import lin, profiling, se3, se3_np
import torch
assert not torch.backends.cuda.matmul.allow_tf32
assert not torch.backends.cudnn.allow_tf32
cfg = config.SlamConfig().replace(sensor=config.SensorConfig(
    horizon_scan=180, max_raw_points=64 * 180))
world = synthetic.make_world(seed=5)
gt = synthetic.circular_trajectory(3, radius=60.0, speed=8.0)
scans = [synthetic.render_scan(world, gt[i], None, horizon=180, seed=i)
         for i in range(2)]
res = driver.replay_odometry(scans, cfg, device="cpu")
assert res.poses.shape == (2, 6) and np.isfinite(res.poses).all()
lanes = batched.replay_batched([scans, scans], cfg, device="cpu")
assert lanes.shape == (2, 2, 6) and np.isfinite(lanes).all()
loaded = [m for m, v in sys.modules.items() if v is not None
          and m.split(".")[0] in ("jax", "jaxlib", "lis_slam_tpu")]
assert not loaded, loaded
assert cuda_build.load.cache_info().currsize == 0  # no nvcc, no ctypes
print("port-ok")
"""


def test_port_imports_and_steps_without_jax():
    root = Path(lis_slam_torch.__file__).resolve().parent.parent
    env = dict(os.environ, PYTHONPATH=str(root))
    proc = subprocess.run([sys.executable, "-c", _HYGIENE], cwd=root,
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "port-ok" in proc.stdout


def test_port_sources_never_import_jax():
    pkg = Path(lis_slam_torch.__file__).resolve().parent
    assert (pkg / "parallel" / "batched.py").exists()  # covered below
    for path in pkg.rglob("*.py"):
        for line in path.read_text().splitlines():
            s = line.strip()
            assert not (s.startswith(("import jax", "from jax"))
                        or "lis_slam_tpu" in s and "import" in s), (
                f"{path.name}: {s}")
