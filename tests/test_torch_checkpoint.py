"""Port parity of checkpoint / resume (lis_slam_torch/runtime/checkpoint.py
against lis_slam_tpu/runtime/checkpoint.py): one file format, so each
package loads what the other wrote.

- The odometry state round trip, and a JAX-written odometry checkpoint
  loaded by the port and the reverse, leaves bit-equal.
- Full SemanticSlam at the tests/_torch_plaza.py:tiny_cfgs size (submaps
  cut at 4 m, keyframe clouds released one submap after close, so the
  checkpoints hold released keyframes): JAX runs scans 0..K-1 and saves;
  the port loads that file and continues, and the JAX run continues
  uninterrupted; the port saves at scan M, and the JAX package loads that
  file and continues beside the port. Each continuation's first pose is
  held at the front-end step's bounds (5e-3 m / 5e-4 rad, from the same
  state), the finished runs at tests/test_torch_slam.py's (raw and
  corrected ATE <= 1.5 x the JAX run's + 0.02 m, submaps within +-1).
- The port's own resume from scan M equals its uninterrupted run from the
  same JAX checkpoint: raw poses within 1e-4, corrected within 5e-3
  (tests/test_io_runtime.py:185-190), the same submaps.
"""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")

import jax
import jax.numpy as jnp
import torch

from lis_slam_tpu.pipeline import driver as jdriver, odometry as jodom
from lis_slam_tpu.pipeline import slam as jslam, trajectory as jtraj
from lis_slam_tpu.runtime import checkpoint as jckpt
from lis_slam_torch.pipeline import driver, odometry, slam, trajectory
from lis_slam_torch.runtime import checkpoint as ckpt

from _torch_plaza import render_plaza, tiny_cfgs

POS_ATOL, ANG_ATOL = 5e-3, 5e-4  # the front-end step's bounds
K, M, N = 16, 18, 20  # JAX checkpoint, port checkpoint, end


def _random_state(template, seed):
    """The template's fields filled with seeded values of the same dtype."""
    rng = np.random.default_rng(seed)
    out = {}
    for f in template._fields:
        a = np.asarray(getattr(template, f))
        if a.dtype == np.bool_:
            out[f] = rng.random(a.shape) > 0.5
        elif np.issubdtype(a.dtype, np.integer):
            out[f] = rng.integers(-1000, 1000, a.shape).astype(a.dtype)
        else:
            out[f] = rng.normal(size=a.shape).astype(a.dtype)
    return out


def _assert_leaves_equal(torch_state, arrays):
    for f in torch_state._fields:
        a = getattr(torch_state, f).numpy()
        b = np.asarray(arrays[f])
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)


def test_odom_state_round_trip(tmp_path):
    _, cfg = tiny_cfgs()
    template = odometry.init_state(cfg, "cpu")
    vals = _random_state(template, 0)
    state = odometry.OdomState(**{f: torch.from_numpy(v)
                                  for f, v in vals.items()})
    p = str(tmp_path / "odom.npz")
    ckpt.save_odom_state(p, state, extra={"scan": 42})
    loaded, extra = ckpt.load_odom_state(p, template)
    assert extra == {"scan": 42}
    _assert_leaves_equal(loaded, vals)
    assert loaded.pose.device.type == "cpu"


def test_odom_checkpoint_crosses_packages(tmp_path):
    jcfg, tcfg = tiny_cfgs()
    jtemplate = jodom.init_state(jcfg)
    ttemplate = odometry.init_state(tcfg, "cpu")
    # JAX writes, the port reads
    vals = _random_state(jtemplate, 1)
    p = str(tmp_path / "jax.npz")
    jckpt.save_odom_state(p, jtemplate._replace(
        **{f: jnp.asarray(v) for f, v in vals.items()}), extra={"k": 1})
    loaded, extra = ckpt.load_odom_state(p, ttemplate)
    assert extra == {"k": 1}
    _assert_leaves_equal(loaded, vals)
    # the port writes, JAX reads
    vals = _random_state(ttemplate, 2)
    p = str(tmp_path / "port.npz")
    ckpt.save_odom_state(p, odometry.OdomState(
        **{f: torch.from_numpy(v) for f, v in vals.items()}))
    jloaded, _ = jckpt.load_odom_state(p, jtemplate)
    assert (jax.tree_util.tree_structure(jloaded)
            == jax.tree_util.tree_structure(jtemplate))
    for f in jtemplate._fields:
        a = np.asarray(getattr(jloaded, f))
        assert a.dtype == vals[f].dtype, f
        np.testing.assert_array_equal(a, vals[f], err_msg=f)


def _slam_cfgs():
    j, t = tiny_cfgs()

    def cut(c):
        return c.replace(submap=dataclasses.replace(
            c.submap, translation_max=4.0, release_after_submaps=1))

    return cut(j), cut(t)


def _feed(system, drv, cfg, scans, lo, hi):
    """Scans lo..hi-1 into `system`; returns the first one's pose."""
    first = None
    for i in range(lo, hi):
        s = scans[i]
        pose = system.process_scan(drv.pad_scan(s.points[s.valid], cfg),
                                   gt_labels=s.labels[s.valid],
                                   timestamp=i * 0.1)
        if first is None:
            first = np.asarray(pose.cpu() if isinstance(pose, torch.Tensor)
                               else pose, np.float64)
    return first


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jcfg, tcfg = _slam_cfgs()
    scans, gt = render_plaza(N)
    d = tmp_path_factory.mktemp("ckpt")
    p_jax, p_port = str(d / "jax.npz"), str(d / "port.npz")
    out = {"gt": gt}

    ja = jslam.SemanticSlam(jcfg)
    _feed(ja, jdriver, jcfg, scans, 0, K)
    jckpt.save_slam(p_jax, ja)
    out["released_at_K"] = sum(kf.released for kf in ja.keyframes)
    out["jax_first_K"] = _feed(ja, jdriver, jcfg, scans, K, N)
    out["jax_from_K"] = ja.finish()

    # the port from the JAX checkpoint, saving at M
    p1 = slam.SemanticSlam(tcfg, device="cpu")
    ckpt.load_slam(p_jax, p1)
    out["port_loaded_released"] = [kf.released for kf in p1.keyframes]
    out["port_first_K"] = _feed(p1, driver, tcfg, scans, K, M)
    ckpt.save_slam(p_port, p1)
    out["port_first_M"] = _feed(p1, driver, tcfg, scans, M, N)
    out["port_saved_at_M"] = p1.finish()
    del p1

    # a fresh port system resumed at M, and one run uninterrupted from K
    p2 = slam.SemanticSlam(tcfg, device="cpu")
    ckpt.load_slam(p_port, p2)
    _feed(p2, driver, tcfg, scans, M, N)
    out["port_resumed_M"] = p2.finish()
    p3 = slam.SemanticSlam(tcfg, device="cpu")
    ckpt.load_slam(p_jax, p3)
    _feed(p3, driver, tcfg, scans, K, N)
    out["port_from_K"] = p3.finish()

    # JAX from the port's checkpoint
    j2 = jslam.SemanticSlam(jcfg)
    jckpt.load_slam(p_port, j2)
    out["jax_first_M"] = _feed(j2, jdriver, jcfg, scans, M, N)
    out["jax_from_M"] = j2.finish()
    return out


def _pose_close(a, b):
    np.testing.assert_allclose(a[3:], b[3:], atol=POS_ATOL)
    np.testing.assert_allclose(a[:3], b[:3], atol=ANG_ATOL)


def _runs_close(tres, jres, gt):
    gt_rel = trajectory.relative_to_first(gt[:N])
    assert np.isfinite(tres.poses).all() and tres.poses.shape == (N, 6)
    assert abs(tres.n_submaps - jres.n_submaps) <= 1
    for f in ("raw_poses", "poses"):
        a = trajectory.ate_rmse(getattr(tres, f), gt_rel, align=True)
        j = jtraj.ate_rmse(getattr(jres, f), gt_rel, align=True)
        assert a <= 1.5 * j + 0.02, (f, a, j)


def test_jax_checkpoint_resumes_in_port(runs):
    # the JAX file held released keyframes, and they stay released
    assert runs["released_at_K"] > 0
    assert sum(runs["port_loaded_released"]) == runs["released_at_K"]
    _pose_close(runs["port_first_K"], runs["jax_first_K"])
    _runs_close(runs["port_from_K"], runs["jax_from_K"], runs["gt"])


def test_port_checkpoint_resumes_in_jax(runs):
    _pose_close(runs["jax_first_M"], runs["port_first_M"])
    _runs_close(runs["port_saved_at_M"], runs["jax_from_M"], runs["gt"])


def test_port_resume_equals_uninterrupted(runs):
    a, b = runs["port_resumed_M"], runs["port_from_K"]
    assert a.poses.shape == b.poses.shape == (N, 6)
    np.testing.assert_allclose(a.raw_poses, b.raw_poses, atol=1e-4)
    np.testing.assert_allclose(a.poses, b.poses, atol=5e-3)
    assert a.n_submaps == b.n_submaps


def test_state_setter_refreshes_host_pose():
    """With the IMU fields, the state setter keeps the LIO chain's host
    copy of the pose in step with the odometry state."""
    _, tcfg = _slam_cfgs()
    cfg = tcfg.replace(imu=dataclasses.replace(tcfg.imu, use_imu=True))
    system = slam.SemanticSlam(cfg, device="cpu")
    pose = torch.tensor([0.01, -0.02, 0.3, 1.0, 2.0, 0.5])
    system.state = system.state._replace(pose=pose)
    assert system.fstate.odom_pose_host.dtype == torch.float64
    np.testing.assert_array_equal(system.fstate.odom_pose_host.numpy(),
                                  pose.double().numpy())
    assert system.state.pose is pose
    sem = system.sem_state._replace(pose=pose)
    system.sem_state = sem
    assert system.fstate.sem is sem
    # without the IMU there is no host copy to refresh
    plain = slam.SemanticSlam(tcfg, device="cpu")
    plain.state = plain.state._replace(pose=pose)
    assert plain.fstate.odom_pose_host is None
