"""The port against the numpy reference replica (its own copy,
lis_slam_torch/golden/replica.py, pinned to the JAX package's by
tests/test_torch_host.py): the counterparts of
tests/test_golden_replica.py:123, :195 and :238, at those tests' bars.

- Front-end odometry (driver.replay_odometry) against the replica's
  reference-math odometry on 30 HDL-64 scans of the circuit
  (make_world(seed=5), radius 60 m, 8 m/s, 1 cm noise): divergence under
  1% of the distance travelled, and ATE under 1.2 x the replica's
  + 0.02 m. The scans come from the port's torch renderer on the CPU
  (io/synthetic_torch.py, ~0.8 s a scan here against ~6 s for the numpy
  renderer), so the run fits the file's time.
- The semantic-weighted scan-to-submap solve and the submap-to-submap
  registration (ops/scan_match.scan_to_map) against the replica's on the
  same structured scene: both within 8e-3 of the true pose, within 1e-2
  of each other.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from lis_slam_torch.config import SensorConfig, SlamConfig
from lis_slam_torch.golden import replica
from lis_slam_torch.io import synthetic, synthetic_torch
from lis_slam_torch.ops import scan_match
from lis_slam_torch.pipeline import driver, trajectory


@pytest.fixture(scope="module")
def hdl64_cfg():
    return SlamConfig().replace(sensor=SensorConfig(max_raw_points=64 * 1800))


def test_odometry_within_1pct_of_replica(hdl64_cfg):
    n = 30
    world = synthetic_torch.to_device_world(synthetic.make_world(seed=5),
                                            "cpu")
    gt = synthetic.circular_trajectory(n + 1, radius=60.0, speed=8.0)
    gen = torch.Generator().manual_seed(50)
    scans = []
    for i in range(n):
        p, _lab, v = synthetic_torch.render_scan_device(
            world, torch.as_tensor(gt[i]), gen, noise=0.01)
        scans.append(SimpleNamespace(points=p.numpy(), valid=v.numpy()))
    odo = replica.ReferenceReplicaOdometry(hdl64_cfg)
    rep = np.stack([odo.process(s.points[:, :3].astype(np.float64), s.valid)
                    for s in scans])
    port = driver.replay_odometry(scans, hdl64_cfg, device="cpu").poses
    gt_rel = trajectory.relative_to_first(gt[:n])
    travel = np.sum(np.linalg.norm(np.diff(gt_rel[:, 3:], axis=0), axis=1))
    div = trajectory.ate_rmse(port, rep, align=False)
    ate_port = trajectory.ate_rmse(port, gt_rel, align=False)
    ate_rep = trajectory.ate_rmse(rep, gt_rel, align=False)
    assert div < 0.01 * travel, (div, travel, ate_port, ate_rep)
    assert ate_port < 1.2 * ate_rep + 0.02


def _structured_scene(rng, n_line_pts=600, n_plane_pts=4000):
    """tests/test_golden_replica.py's scene: 40 poles for the corner
    solver, a ground patch and two walls for the surf solver."""
    poles = []
    for _ in range(40):
        x, y = rng.uniform(-25, 25, 2)
        z = rng.uniform(0, 5, n_line_pts // 40)
        poles.append(np.stack([
            np.full_like(z, x) + rng.normal(0, 0.01, z.shape),
            np.full_like(z, y) + rng.normal(0, 0.01, z.shape), z], 1))
    corners = np.concatenate(poles).astype(np.float64)
    n3 = n_plane_pts // 3
    ground = np.stack([rng.uniform(-14, 14, n3), rng.uniform(-14, 14, n3),
                       rng.normal(0, 0.01, n3)], 1)
    wall1 = np.stack([rng.uniform(-30, 30, n3),
                      np.full(n3, 12.0) + rng.normal(0, 0.01, n3),
                      rng.uniform(0, 6, n3)], 1)
    wall2 = np.stack([np.full(n3, -14.0) + rng.normal(0, 0.01, n3),
                      rng.uniform(-30, 30, n3), rng.uniform(0, 6, n3)], 1)
    return corners, np.concatenate([ground, wall1, wall2]).astype(np.float64)


def _pad(arr, cap):
    out = np.zeros((cap, arr.shape[1]), np.float32)
    out[:len(arr)] = arr
    return torch.from_numpy(out), torch.arange(cap) < len(arr)


def _weights(w, cap):
    out = torch.zeros(cap)
    out[:len(w)] = torch.as_tensor(w, dtype=torch.float32)
    return out


@pytest.mark.parametrize("case", ["semantic_refine", "submap_registration"])
def test_backend_solver_matches_replica(hdl64_cfg, case):
    semantic = case == "semantic_refine"
    rng = np.random.default_rng(11 if semantic else 13)
    map_c, map_s = _structured_scene(rng)
    true_pose = (np.array([0.004, -0.006, 0.02, 0.3, -0.2, 0.05]) if semantic
                 else np.array([0.002, 0.003, -0.015, -0.25, 0.15, 0.02]))
    Ti = np.linalg.inv(replica.pose_to_matrix(true_pose))
    nc, ns = (250, 1200) if semantic else (300, 1500)
    cur_c = replica.transform_points(
        Ti, map_c[rng.choice(len(map_c), nc, replace=False)])
    cur_s = replica.transform_points(
        Ti, map_s[rng.choice(len(map_s), ns, replace=False)])
    cfg = hdl64_cfg
    args = (*_pad(cur_c, 512), *_pad(cur_s, 2048), *_pad(map_c, 1024),
            *_pad(map_s, 8192), cfg.matching)
    if semantic:
        w_c = rng.uniform(0.5, 1.5, len(cur_c))
        w_s = rng.uniform(0.5, 1.5, len(cur_s))
        rep_pose = replica.scan_to_submap_semantic(
            np.zeros(6), cur_c, w_c, cur_s, w_s, map_c, map_s, cfg,
            max_iter=20)
        gn = scan_match.scan_to_map(
            torch.zeros(6), *args, 20, corner_sem_weight=_weights(w_c, 512),
            surf_sem_weight=_weights(w_s, 2048))
    else:
        rep_pose = replica.submap_to_submap(
            np.zeros(6), cur_c, cur_s, map_c, map_s, cfg, max_iter=30)
        gn = scan_match.scan_to_map(
            torch.zeros(6), *args, cfg.matching.max_iterations_submap2submap)
    port_pose = gn.pose.numpy().astype(np.float64)
    np.testing.assert_allclose(rep_pose, true_pose, atol=8e-3)
    np.testing.assert_allclose(port_pose, true_pose, atol=8e-3)
    np.testing.assert_allclose(port_pose, rep_pose, atol=1e-2)
