"""The JAX package's API-contract tests, held against the port.

Each test function of tests/test_robustness.py, test_round3.py,
test_round3_async.py, test_round4.py, test_round5.py and
test_epsc_naive_replica.py is either restated here on the port (the same
scenario and the same assertion, device="cpu"), held by a named port test
that asserts the same contract, or listed with the reason it does not
apply. The scenarios are the JAX tests' own: micro_cfg (16 x 360 beams)
for the robustness cases, tiny_cfg (16 x 900) for the pipeline cases,
tests/test_round4.py's motion-distorted 16-beam circuit for the IMU cases,
built here from the port's config classes and its numpy renderer.

Restated here under the same name:
  test_robustness.py: all five (test_finish_with_zero_scans,
    test_finish_fewer_scans_than_drain_batch, test_finish_is_idempotent,
    test_process_after_finish_continues, test_all_points_invalid_scan).
  test_round3.py: all six (test_accel_bias_recovery,
    test_extrpy_remap_identity, test_extrpy_remap_yaw,
    test_keyframe_gate_requires_convergence,
    test_loop_scoring_scales_flat_with_db_size,
    test_refine_icp_fallback_on_degenerate_scene).
  test_round3_async.py: test_lm_converges_where_gn_oscillated,
    test_graph_bucket_padding_matches_full_padding,
    test_voxel_downsample_payloads_aligned,
    test_voxel_merge_aged_flag_rides_sort,
    test_voxel_merge_aged_anchor_semantics,
    test_stacked_submap_merge_world_frame_and_classes,
    test_gps_fix_in_open_submap_waits_not_dropped.
  test_round4.py: test_slam_with_imu_fusion (slow),
    test_loop_pair_dedup_single_factor, test_verify_skips_existing_pair,
    test_loop_factor_triggers_optimize_next_drain,
    test_predict_imu_rate_tracks_gt (slow).
  test_round5.py: test_pad_scan_gyro_only_accel_is_gravity_neutral,
    test_pad_scan_routes_explicit_accel,
    test_clamped_two_window_update_keeps_prior_marginal,
    test_keyframe_clouds_released_after_submap_close,
    test_release_disabled_when_zero, test_gps_index_is_incremental,
    test_class_merge_threads_per_point_weights,
    test_stage3_per_point_weights_match_replica.
  test_epsc_naive_replica.py: test_descriptor_grids_match_naive_loops,
    test_signature_matches_naive_loops (the port's compute_descriptors
    against the same naive per-point loops, imported from that module).

Held by an existing port test:
  test_round4.py::test_kwarg_imu_window_advances_scan_start ->
    tests/test_torch_slam_imu.py::test_kwarg_window_advances_scan_start
    (the window through process_scan's kwargs, scan_start left 0: the
    scan start advances and the two-window update runs).
  test_round4.py::test_slam_imu_failure_reset ->
    tests/test_torch_slam_imu.py::test_imu_reset_at_the_same_drain (the
    same +400 m/s^2 stimulus: at least one reset, at JAX's drains, poses
    finite).
  test_round5.py::test_inert_imu_window_warns ->
    tests/test_torch_slam_imu.py::test_inert_imu_window_warns (the same
    fabricated StepOuts: the warning, and silence on healthy windows).

Does not apply:
  test_round3_async.py::test_submap_bucket_padding_compiles_small pins
    the XLA compile-bounding pad of a closing submap's member count to a
    4-bucket. The port merges exactly the members, with no padding and no
    compile (mapping/submap.py's docstring);
    tests/test_torch_submap.py::test_collector_cuts_and_merges_bit_equal
    holds its merged clouds bit-equal to JAX's padded merge.

Every restated contract holds on the port: none needed a fix.

Two of them run whole SemanticSlam sequences (2 x 40 and 16 distorted
scans) and are `slow`, as in JAX. Four more that JAX marks `slow`
(test_finish_fewer_scans_than_drain_batch, test_loop_scoring_scales_
flat_with_db_size, test_refine_icp_fallback_on_degenerate_scene,
test_stage3_per_point_weights_match_replica) are slow there for their
XLA compiles; the port has none, and they take seconds here.
"""

import dataclasses
import time

import numpy as np
import pytest
import torch

from lis_slam_torch.config import (GraphConfig, ImuConfig, KeyframeConfig,
                                   LoopClosureConfig, SensorConfig,
                                   SlamConfig, SubMapConfig)
from lis_slam_torch.golden import replica
from lis_slam_torch.graph import pose_graph as pg
from lis_slam_torch.imu import preintegration as pi
from lis_slam_torch.io import synthetic
from lis_slam_torch.loop import epsc
from lis_slam_torch.mapping import submap as sm
from lis_slam_torch.ops import scan_match, voxel
from lis_slam_torch.pipeline import driver, odometry, slam, trajectory
from lis_slam_torch.pipeline import semantic_odometry as semo

from test_epsc_naive_replica import (_naive_descriptors, _naive_signature,
                                     cloud)  # noqa: F401  (fixture)
from test_golden_replica import _structured_scene

CPU = "cpu"


def _f64(x):
    return torch.as_tensor(np.asarray(x, np.float64))


def micro_cfg():
    """tests/test_robustness.py's configuration (16 x 360 beams)."""
    base = SlamConfig()
    return base.replace(
        sensor=SensorConfig(
            n_scan=16, horizon_scan=360, downsample_rate=1,
            lidar_min_range=1.0, lidar_max_range=80.0,
            max_raw_points=16 * 360),
        feature=dataclasses.replace(
            base.feature, max_corner_points=512, max_surf_points=2048,
            max_sharp_corner_points=256, max_sharp_surf_points=512),
        matching=dataclasses.replace(
            base.matching, corner_map_capacity=4096, surf_map_capacity=8192,
            hash_table_slots=1 << 12, degeneracy_eigen_threshold=10.0),
        submap=dataclasses.replace(
            base.submap, corner_capacity=4096, surf_capacity=8192,
            local_corner_capacity=4096, local_surf_capacity=8192,
            max_submaps=16),
        keyframe=KeyframeConfig(min_distance=0.2, min_yaw=0.2))


def tiny_cfg():
    """tests/test_slam_pipeline.py's tiny_cfg (16 x 900 beams)."""
    base = SlamConfig()
    return base.replace(
        sensor=SensorConfig(
            n_scan=16, horizon_scan=900, downsample_rate=1,
            lidar_min_range=1.0, lidar_max_range=80.0,
            max_raw_points=16 * 900),
        feature=dataclasses.replace(
            base.feature, max_corner_points=1024, max_surf_points=8192,
            max_sharp_corner_points=512, max_sharp_surf_points=1024),
        matching=dataclasses.replace(
            base.matching, corner_map_capacity=8192, surf_map_capacity=32768,
            hash_table_slots=1 << 14, degeneracy_eigen_threshold=10.0),
        submap=dataclasses.replace(
            base.submap, translation_max=8.0, frames_size=12,
            corner_capacity=8192, surf_capacity=16384, max_submaps=64),
        keyframe=KeyframeConfig(min_distance=0.2, min_yaw=0.2))


def _sixteen_beams(render):
    orig = synthetic.hdl64_elevations
    synthetic.hdl64_elevations = lambda: np.linspace(15.0, -15.0, 16)
    try:
        return render()
    finally:
        synthetic.hdl64_elevations = orig


# ------------------------------------------------------------------------
# test_robustness.py
# ------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_scans():
    world = synthetic.make_world(seed=3)
    gt = synthetic.circular_trajectory(7, radius=30.0, speed=4.0)
    return _sixteen_beams(lambda: [
        synthetic.render_scan(world, gt[i], None, n_scan=16, horizon=360,
                              seed=70 + i, noise=0.01) for i in range(6)])


def _feed(system, scans, cfg):
    for s in scans:
        system.process_scan(driver.pad_scan(s.points[s.valid], cfg))


def test_finish_with_zero_scans():
    system = slam.SemanticSlam(micro_cfg(), device=CPU)
    res = system.finish(build_map=True)
    assert res.poses.shape == (0, 6)
    assert res.raw_poses.shape == (0, 6)
    assert res.n_submaps == 0 and res.n_loops == 0
    assert res.global_map is None


def test_finish_fewer_scans_than_drain_batch(tiny_scans):
    """A 3-scan run never reaches a scheduled drain: finish() flushes the
    pending batch itself."""
    cfg = micro_cfg()
    assert cfg.runtime.drain_every > 3
    system = slam.SemanticSlam(cfg, device=CPU)
    _feed(system, tiny_scans[:3], cfg)
    res = system.finish()
    assert res.poses.shape == (3, 6)
    assert np.all(np.isfinite(res.poses))


def test_finish_is_idempotent(tiny_scans):
    cfg = micro_cfg()
    system = slam.SemanticSlam(cfg, device=CPU)
    _feed(system, tiny_scans, cfg)
    r1 = system.finish()
    r2 = system.finish()
    np.testing.assert_allclose(r2.raw_poses, r1.raw_poses)
    assert r2.n_submaps == r1.n_submaps
    assert r2.poses.shape == r1.poses.shape


def test_process_after_finish_continues(tiny_scans):
    """finish() is the finishMap service, not a destructor."""
    cfg = micro_cfg()
    system = slam.SemanticSlam(cfg, device=CPU)
    _feed(system, tiny_scans[:4], cfg)
    system.finish()
    _feed(system, tiny_scans[4:], cfg)
    res = system.finish()
    assert res.poses.shape == (len(tiny_scans), 6)
    assert np.all(np.isfinite(res.poses))


def test_all_points_invalid_scan(tiny_scans):
    """A dropout scan (no point left) neither crashes nor gives NaNs."""
    cfg = micro_cfg()
    system = slam.SemanticSlam(cfg, device=CPU)
    _feed(system, tiny_scans[:2], cfg)
    system.process_scan(driver.pad_scan(np.zeros((0, 4), np.float32), cfg))
    _feed(system, tiny_scans[2:4], cfg)
    res = system.finish()
    assert res.poses.shape == (5, 6)
    assert np.all(np.isfinite(res.poses))


# ------------------------------------------------------------------------
# test_round3.py
# ------------------------------------------------------------------------


def test_accel_bias_recovery():
    """A stationary body with an injected accelerometer bias: the joint
    bias solve recovers it to < 20% from exact pose anchors, under
    measurement noise."""
    cfg = ImuConfig(use_imu=True, pose_anchor_rot_sigma=1e-3,
                    pose_anchor_pos_sigma=1e-3)
    rng = np.random.default_rng(0)
    ba_true = np.array([0.15, -0.10, 0.05], np.float32)
    state = pi.init_imu_state(cfg)
    m = cfg.max_imu_per_scan
    n_samp = 11
    zero6 = torch.zeros(6, dtype=torch.float64)
    prev_pre, v0 = None, torch.zeros(3, dtype=torch.float64)
    for k in range(60):
        t = np.zeros(m, np.float32)
        t[:n_samp] = k * 0.1 + np.arange(n_samp) * 0.01
        gyro = rng.normal(0, 1e-3, (m, 3)).astype(np.float32)
        accel = np.tile(
            np.array([[0.0, 0.0, cfg.gravity]], np.float32), (m, 1))
        accel += ba_true + rng.normal(0, 5e-3, (m, 3)).astype(np.float32)
        valid = np.arange(m) < n_samp
        pre = pi.preintegrate(_f64(t), _f64(gyro), _f64(accel),
                              torch.from_numpy(valid), state.bg, state.ba,
                              cfg)
        if prev_pre is None:
            state = pi.velocity_bias_update(state, pre, zero6, zero6, cfg)
        else:
            state, v0 = pi.velocity_bias_update2(
                state, prev_pre, pre, zero6, zero6, zero6, v0, cfg)
        prev_pre = pre
    ba_est = state.ba.numpy()
    rel_err = np.linalg.norm(ba_est - ba_true) / np.linalg.norm(ba_true)
    assert rel_err < 0.2, f"ba {ba_est} vs {ba_true} (rel {rel_err:.2f})"
    assert np.linalg.norm(state.bg.numpy()) < 0.02
    assert np.linalg.norm(state.v.numpy()) < 0.05  # stationary


def test_extrpy_remap_identity():
    ident = dataclasses.replace(
        ImuConfig(), extrinsic_rpy=((1, 0, 0), (0, 1, 0), (0, 0, 1)))
    rpy = np.array([0.1, -0.2, 0.7])
    np.testing.assert_allclose(pi.remap_imu_orientation(rpy, ident), rpy,
                               atol=1e-9)


def test_extrpy_remap_yaw():
    """q_final = q_from * extQRPY: an identity orientation maps to the
    extrinsic itself, and yaws compose additively."""
    th = 0.3
    c, s = np.cos(th), np.sin(th)
    cfg = dataclasses.replace(
        ImuConfig(), extrinsic_rpy=((c, -s, 0), (s, c, 0), (0, 0, 1)))
    np.testing.assert_allclose(pi.remap_imu_orientation(np.zeros(3), cfg),
                               [0, 0, th], atol=1e-9)
    np.testing.assert_allclose(
        pi.remap_imu_orientation(np.array([0, 0, 0.2]), cfg),
        [0, 0, 0.2 + th], atol=1e-9)


def _gn(delta_r, delta_t):
    return scan_match.GNState(
        pose=torch.zeros(6), proj=torch.eye(6), degenerate=False,
        converged=True, n_valid=1000, it=3, delta_r=delta_r,
        delta_t=delta_t)


def test_keyframe_gate_requires_convergence():
    """Keyframes only when the last step was small; the first frame (or
    bootstrap_frames) keyframes on convergence alone; then per-axis
    motion gates apply."""
    cfg = SlamConfig()
    gate = odometry._keyframe_gate
    pose_far = torch.tensor([0, 0, 0, 5.0, 0, 0])
    last = torch.zeros(6)
    many = 50
    assert gate(pose_far, last, many, _gn(1e-4, 1e-3), cfg)
    assert not gate(pose_far, last, many, _gn(1.0, 10.0), cfg)
    assert not gate(last, last, many, _gn(1e-4, 1e-3), cfg)
    cfg_boot = cfg.replace(
        keyframe=dataclasses.replace(cfg.keyframe, bootstrap_frames=5))
    assert gate(last, last, 2, _gn(1e-4, 1e-3), cfg_boot)
    assert not gate(last, last, 2, _gn(1e-4, 1e-3), cfg)
    assert gate(last, last, 0, _gn(1e-4, 1e-3), cfg)
    pose_y = torch.tensor([0, 0, 0, 0, 5.0, 0])
    assert gate(pose_y, last, many, _gn(1e-4, 1e-3), cfg)


def test_loop_scoring_scales_flat_with_db_size():
    """Per-keyframe loop detection cost does not grow with the descriptor
    database: wall time at 1500 keyframes within 3x of 100 (+ 0.05 s)."""
    cfg = LoopClosureConfig()
    rng = np.random.default_rng(0)
    n_pts = 2000
    pts = torch.from_numpy(rng.uniform(-40, 40, (n_pts, 3)).astype(np.float32))
    lab = torch.from_numpy(rng.integers(9, 19, n_pts).astype(np.int32))
    clouds = epsc.CloudRefs(
        sem_xyz=pts, sem_intensity=torch.full((n_pts,), 0.5),
        sem_label=lab, sem_valid=torch.ones(n_pts, dtype=torch.bool),
        corner_xyz=pts[:200], corner_valid=torch.ones(200, dtype=torch.bool),
        surf_xyz=pts[200:1200],
        surf_valid=torch.ones(1000, dtype=torch.bool))
    desc = torch.from_numpy(
        rng.uniform(0, 255, (cfg.rings, cfg.sectors)).astype(np.float32))
    sig = torch.from_numpy(rng.uniform(0, 5, (360, 4)).astype(np.float32))

    def timed_detect(db_size):
        det = epsc.LoopDetector(cfg)
        for i in range(db_size):
            det.append(desc, sig, np.array([2.0 * i, 0.0, 0.0]))
        pose = np.array([0.5, 0.3, 0.0])
        ids = det.gate(pose)
        assert len(ids) > 0
        [r.numpy() for r in det.score_async(ids, sig, clouds, pose)]
        t0 = time.perf_counter()
        for _ in range(3):
            ids = det.gate(pose)
            [r.numpy() for r in det.score_async(ids, sig, clouds, pose)]
        return time.perf_counter() - t0

    t_small = timed_detect(100)
    t_large = timed_detect(1500)
    assert t_large < 3.0 * t_small + 0.05, (t_small, t_large)


def test_refine_icp_fallback_on_degenerate_scene():
    """A corridor (one long wall): the semantic GN refine degenerates
    along the wall and the ICP fallback pulls y back onto it. The JAX
    test's scene; the scan and local-map buffers are cut from 8192 /
    65536 to 2048 / 16384 rows (they hold the 1500 wall points either
    way), which takes the CPU ICP from ~60 s to a few seconds."""
    base = SlamConfig()
    cfg = base.replace(
        matching=dataclasses.replace(
            base.matching, degeneracy_eigen_threshold=1e5,
            min_valid_points=10),
        feature=dataclasses.replace(base.feature, max_surf_points=2048),
        submap=dataclasses.replace(base.submap, local_surf_capacity=16384))
    rng = np.random.default_rng(1)
    qc, qs = cfg.submap.corner_capacity // 8, cfg.feature.max_surf_points
    qk = cfg.submap.keyframe_class_capacity
    n_wall = 1500
    wall = np.stack([
        rng.uniform(-30, 30, n_wall),
        np.full(n_wall, 2.0) + rng.normal(0, 0.005, n_wall),
        rng.uniform(0, 4, n_wall)], 1).astype(np.float32)

    def sscan_at(shift):
        pts = wall.copy()
        pts[:, 0] -= shift
        s_xyz = np.zeros((qs, 3), np.float32)
        s_xyz[:n_wall] = pts
        return semo.SemanticScan(
            corner_xyz=torch.zeros((qc, 3)), corner_w=torch.ones(qc),
            corner_mask=torch.zeros(qc, dtype=torch.bool),
            surf_xyz=torch.from_numpy(s_xyz), surf_w=torch.ones(qs),
            surf_mask=torch.arange(qs) < n_wall,
            surf_is_dynamic=torch.zeros(qs, dtype=torch.bool),
            class_xyz=torch.zeros((5, qk, 3)),
            class_mask=torch.zeros((5, qk), dtype=torch.bool))

    state = semo.init_state(cfg, device=CPU)
    state, _p, _g = semo.refine_step(state, sscan_at(0.0), torch.zeros(6),
                                     cfg)
    bad_guess = torch.tensor([0, 0, 0, 3.5, 0.3, 0])
    _s2, pose_fb, gn = semo.refine_step(state, sscan_at(1.0), bad_guess, cfg)
    assert bool(gn.degenerate)
    p = pose_fb.numpy()
    assert np.all(np.isfinite(p))
    assert abs(p[4]) < 0.25, f"y not recovered: {p}"


# ------------------------------------------------------------------------
# test_round3_async.py
# ------------------------------------------------------------------------


def _yawT(th, t):
    T = np.eye(4, dtype=np.float32)
    c, s = np.cos(th), np.sin(th)
    T[:2, :2] = [[c, -s], [s, c]]
    T[:3, 3] = t
    return T


def test_lm_converges_where_gn_oscillated():
    """Strong position priors against a drifted odometry chain: the LM is
    monotone in its iteration count and approaches the priors."""
    cfg = dataclasses.replace(
        GraphConfig(), odom_rot_sigma=1e-2, odom_trans_sigma=1e-1)
    true = [_yawT(0.4 * k, [10 * np.sin(0.4 * k),
                            10 * (1 - np.cos(0.4 * k)), 0]) for k in range(5)]
    drift = [_yawT(0.05 * k, [0, 0, 0]) @ true[k] for k in range(5)]

    def solve(iters):
        gb = pg.GraphBuilder(cfg, 16, 64, 32)
        for k in range(5):
            gb.add_node(drift[k])
            if k:
                gb.add_odom_edge(
                    k - 1, k, np.linalg.inv(drift[k - 1]) @ drift[k])
            gb.add_gps_prior(k, true[k], np.full(3, 0.1))
        opt = gb.optimize(iterations=iters)
        return np.mean([np.linalg.norm(opt[k][:3, 3] - true[k][:3, 3])
                        for k in range(5)])

    e20, e100 = solve(20), solve(100)
    assert e100 <= e20 + 1e-4, f"not monotone: {e20:.4f} -> {e100:.4f}"
    assert e100 < 0.35, f"LM failed to approach GPS priors: {e100:.3f}"


def test_graph_bucket_padding_matches_full_padding():
    """The graph's node capacity does not change the solution."""
    cfg = GraphConfig()

    def build(max_nodes):
        rng = np.random.default_rng(3)
        gb = pg.GraphBuilder(cfg, max_nodes, 64, 32)
        prev = np.eye(4, dtype=np.float32)
        for k in range(6):
            T = _yawT(0.2 * k, [2.0 * k, 0.1 * k, 0])
            gb.add_node(T)
            if k:
                z = np.linalg.inv(prev) @ T
                z = z @ _yawT(0.01 * rng.standard_normal(), [0.02, 0, 0])
                gb.add_odom_edge(k - 1, k, z)
            prev = T
        return gb.optimize()

    np.testing.assert_allclose(build(8), build(256), atol=1e-5)


def test_voxel_downsample_payloads_aligned():
    """Payload columns come out aligned with their kept points."""
    rng = np.random.default_rng(0)
    n = 500
    pts = rng.uniform(0, 10, (n, 3)).astype(np.float32)
    w = np.arange(n, dtype=np.float32)
    out, om, _k, ow = voxel.voxel_downsample(
        torch.from_numpy(pts), torch.ones(n, dtype=torch.bool), 0.5, 512,
        payloads=(torch.from_numpy(w),))
    out, om, ow = out.numpy(), om.numpy(), ow.numpy()
    assert om.any()
    for i in np.nonzero(om)[0][:50]:
        j = int(np.argmin(np.linalg.norm(pts - out[i], axis=1)))
        assert np.linalg.norm(pts[j] - out[i]) < 1e-6
        assert ow[i] == w[j]


def test_voxel_merge_aged_flag_rides_sort():
    """The dynamic-class flag follows its point through the aged merge."""
    C = 16
    pts, _age, mask, flag = voxel.voxel_merge_aged(
        torch.tensor([[0.0, 0, 0], [5, 0, 0], [0, 5, 0]]),
        torch.ones(3, dtype=torch.bool), torch.zeros((C, 3)),
        torch.full((C,), -(10**9), dtype=torch.int32),
        torch.zeros(C, dtype=torch.bool), 0, 10, 0.5, C,
        new_flag=torch.tensor([True, False, True]),
        map_flag=torch.zeros(C, dtype=torch.bool))
    got = {tuple(np.round(pts[i].numpy()).astype(int)): bool(flag[i])
           for i in np.nonzero(mask.numpy())[0]}
    assert got == {(0, 0, 0): True, (5, 0, 0): False, (0, 5, 0): True}


def test_voxel_merge_aged_anchor_semantics():
    """Re-observing a voxel: "first" keeps the anchored map position and
    refreshes only the age; "newest" replaces the position. The flag
    follows the anchored point in both modes."""
    C = 16
    map_pts = torch.zeros((C, 3))
    map_pts[0] = torch.tensor([1.0, 0.0, 0.0])
    map_age = torch.full((C,), -(10**9), dtype=torch.int32)
    map_age[0] = 3
    map_mask = torch.zeros(C, dtype=torch.bool)
    map_mask[0] = True
    new_pts = torch.tensor([[1.3, 0.2, 0.0]])
    for anchor, want_x, want_flag in (("first", 1.0, False),
                                      ("newest", 1.3, True)):
        pts, age, mask, flag = voxel.voxel_merge_aged(
            new_pts, torch.ones(1, dtype=torch.bool), map_pts, map_age,
            map_mask, 7, 10, 2.0, C, anchor=anchor,
            new_flag=torch.ones(1, dtype=torch.bool),
            map_flag=torch.zeros(C, dtype=torch.bool))
        i = int(np.nonzero(mask.numpy())[0][0])
        assert int(mask.sum()) == 1
        assert abs(float(pts[i, 0]) - want_x) < 1e-6, anchor
        assert int(age[i]) == 7, f"{anchor}: age must refresh"
        assert bool(flag[i]) == want_flag, anchor


def _mk_cloud_kf(i, x, rng):
    pose = np.eye(4)
    pose[0, 3] = x
    pts = torch.from_numpy(rng.uniform(-5, 5, (128, 3)).astype(np.float32))
    cls = torch.from_numpy(rng.uniform(-5, 5, (5, 16, 3)).astype(np.float32))
    return sm.Keyframe(
        index=i, pose_init=pose, pose_opt=pose.copy(),
        clouds=sm.ClassClouds(xyz=cls, mask=torch.ones((5, 16),
                                                       dtype=torch.bool)),
        corner_xyz=pts[:32], corner_mask=torch.ones(32, dtype=torch.bool),
        surf_xyz=pts, surf_mask=torch.ones(128, dtype=torch.bool))


def test_stacked_submap_merge_world_frame_and_classes():
    """The stacked merge places member clouds at their keyframe poses and
    fills the per-class submap clouds; the bbox stays on the device until
    get_bbox reads it."""
    coll = sm.SubMapCollector(SubMapConfig(frames_size=3,
                                           translation_max=1e9, yaw_max=1e9))
    coll.merge_classes = True
    rng = np.random.default_rng(7)
    finished = None
    for i in range(4):
        finished = coll.add_keyframe(_mk_cloud_kf(i, 10.0 * i, rng)) \
            or finished
    assert finished is not None
    surf = finished.surf_xyz.numpy()[finished.surf_mask.numpy()]
    assert surf[:, 0].max() > 24.0
    assert finished.class_xyz is not None
    assert bool(finished.class_mask.any())
    assert finished.bbox is None
    bb = finished.get_bbox()
    assert bb is not None and bb.shape == (2, 3)
    assert bb[1][0] > 24.0


def _fab_kf(i, t=0.0, submap_id=-1, T=None):
    """A keyframe with empty clouds at x = i (or at T)."""
    if T is None:
        T = np.eye(4)
        T[0, 3] = i * 1.0
    return sm.Keyframe(
        index=i, pose_init=T, pose_opt=T.copy(), timestamp=t,
        clouds=sm.ClassClouds(torch.zeros((5, 4, 3)),
                              torch.zeros((5, 4), dtype=torch.bool)),
        corner_xyz=torch.zeros((8, 3)),
        corner_mask=torch.zeros(8, dtype=torch.bool),
        surf_xyz=torch.zeros((8, 3)),
        surf_mask=torch.zeros(8, dtype=torch.bool), submap_id=submap_id)


def _fab_submap(index, T, kf_indices=(), kf_rel_poses=()):
    return sm.SubMap(
        index=index, pose_init=T.astype(np.float64), pose_opt=T.copy(),
        corner_xyz=torch.zeros((4, 3)),
        corner_mask=torch.zeros(4, dtype=torch.bool),
        surf_xyz=torch.zeros((4, 3)),
        surf_mask=torch.zeros(4, dtype=torch.bool),
        kf_indices=list(kf_indices), kf_rel_poses=list(kf_rel_poses))


def test_gps_fix_in_open_submap_waits_not_dropped():
    """A fix timestamped inside the open submap stays queued until that
    submap closes; one matching a closed submap attaches at once."""
    system = slam.SemanticSlam(tiny_cfg(), device=CPU)
    system.keyframes += [_fab_kf(0, 0.0, 0), _fab_kf(1, 0.5, 0)]
    system.collector.submaps.append(_fab_submap(
        0, np.eye(4), [0, 1], [np.eye(4), system.keyframes[1].pose_init]))
    system.graph.add_node(np.eye(4))
    system.keyframes.append(_fab_kf(2, 2.0))  # not in any submap yet
    assert system.add_gps(np.array([2.0, 0, 0]), np.full(3, 0.01),
                          timestamp=2.0)
    assert system._gps_dropped == 0
    assert len(system._gps_queue) == 1  # waiting for the open submap
    system.add_gps(np.array([0.5, 0, 0]), np.full(3, 0.01), timestamp=0.5)
    assert len(system.graph.priors) >= 2  # anchor + attached fix
    assert system._gps_dropped == 0


# ------------------------------------------------------------------------
# test_round4.py
# ------------------------------------------------------------------------


def _round4_plaza(rng):
    """tests/test_round4.py's plaza: 14 buildings on a 26 m ring, 24
    poles."""
    boxes = []
    for k in range(14):
        ang = 2 * np.pi * k / 14
        cx, cy = 26.0 * np.cos(ang), 10.0 + 26.0 * np.sin(ang)
        w, d, h = rng.uniform(5, 9), rng.uniform(5, 9), rng.uniform(5, 14)
        boxes.append([cx - w / 2, cy - d / 2, 0, cx + w / 2, cy + d / 2, h])
    poles = [[r * np.cos(a), 10.0 + r * np.sin(a), 0.15, 5.0]
             for a, r in zip(np.linspace(0, 2 * np.pi, 24),
                             rng.uniform(15, 20, 24))]
    return synthetic.World(
        boxes=np.asarray(boxes),
        box_labels=np.full(14, synthetic.LBL_BUILDING, np.int32),
        poles=np.asarray(poles))


@pytest.fixture(scope="module")
def distorted_sequence():
    """Motion-distorted 16 x 900 sweeps with their IMU windows on a tight
    circuit (tests/test_round4.py's fixture)."""
    world = _round4_plaza(np.random.default_rng(9))
    n = 40
    gt = synthetic.circular_trajectory(n + 1, radius=10.0, speed=6.3)
    scans = _sixteen_beams(lambda: [
        synthetic.render_scan(world, gt[i], gt[i + 1], n_scan=16,
                              horizon=900, seed=300 + i, noise=0.01,
                              max_range=90.0) for i in range(n)])
    return scans, gt


def _lio_cfg():
    return tiny_cfg().replace(imu=dataclasses.replace(
        ImuConfig(), use_imu=True, max_imu_per_scan=64))


@pytest.mark.slow
def test_slam_with_imu_fusion(distorted_sequence):
    """On motion-distorted scans with a noisy IMU, full SLAM with the IMU
    tracks at least as well as the lidar-only run (aligned ATE), with no
    reset."""
    scans, gt = distorted_sequence
    n = len(scans)
    gt_rel = trajectory.relative_to_first(gt[:n])
    rng = np.random.default_rng(5)
    cfg0 = tiny_cfg()
    sys0 = slam.SemanticSlam(cfg0, device=CPU)
    for i, s in enumerate(scans):
        sys0.process_scan(
            driver.pad_scan(s.points[s.valid], cfg0, scan_start=i * 0.1),
            gt_labels=s.labels[s.valid], timestamp=i * 0.1)
    res0 = sys0.finish()
    cfg1 = _lio_cfg()
    sys1 = slam.SemanticSlam(cfg1, device=CPU)
    for i, s in enumerate(scans):
        sys1.process_scan(
            driver.pad_scan(s.points[s.valid], cfg1, scan_start=i * 0.1),
            gt_labels=s.labels[s.valid], timestamp=i * 0.1,
            imu_time=s.imu_time + i * 0.1,
            imu_gyro=s.gyro + rng.normal(0, 2e-3, s.gyro.shape),
            imu_accel=s.accel + rng.normal(0, 1e-2, s.accel.shape))
    res1 = sys1.finish()
    ate0 = trajectory.ate_rmse(res0.raw_poses, gt_rel, align=True)
    ate1 = trajectory.ate_rmse(res1.raw_poses, gt_rel, align=True)
    assert np.all(np.isfinite(res1.raw_poses))
    assert sys1.n_imu_resets == 0
    assert ate1 <= ate0, f"LIO-SLAM ATE {ate1:.3f} vs lidar-only {ate0:.3f}"
    assert ate1 < 0.15, f"LIO-SLAM aligned ATE {ate1:.3f}"


def _two_submaps(system):
    for si in range(2):
        T = np.eye(4)
        T[0, 3] = 10.0 * si
        system.collector.submaps.append(_fab_submap(si, T))
        system.graph.add_node(T)


def test_loop_pair_dedup_single_factor():
    """At most one loop factor per submap pair: three verified loops
    between the same two submaps add one factor, and a later one none."""
    system = slam.SemanticSlam(tiny_cfg(), device=CPU)
    _two_submaps(system)
    system.keyframes = [_fab_kf(0, submap_id=0), _fab_kf(1, submap_id=1),
                        _fab_kf(2, submap_id=1), _fab_kf(3, submap_id=1)]
    T_loop = np.eye(4)
    system.loops = [(1, 0, T_loop, 0.1), (2, 0, T_loop, 0.1),
                    (3, 0, T_loop, 0.1)]
    assert system._flush_loop_factors()
    assert system._n_loop_factors == 1
    assert system._loop_pairs == {(0, 1)}
    system.loops = [(3, 0, T_loop, 0.05)]
    assert not system._flush_loop_factors()
    assert system._n_loop_factors == 1


def test_verify_skips_existing_pair():
    """_dispatch_verify skips a candidate whose submap pair already holds
    a factor, before any ICP is dispatched."""
    system = slam.SemanticSlam(tiny_cfg(), device=CPU)
    system.collector.submaps.append(_fab_submap(0, np.eye(4)))
    system.keyframes = [_fab_kf(0, submap_id=0), _fab_kf(1)]  # kf1 open
    system._loop_pairs.add((0, 1))  # factor already in flight
    cand = epsc.LoopCandidate(matched_id=0, score=0.1, transform=np.eye(4))
    system._dispatch_verify(1, cand)
    assert not system._pending_verify


def test_loop_factor_triggers_optimize_next_drain():
    """A verified loop factor dispatches a global optimize within one
    drain."""
    system = slam.SemanticSlam(tiny_cfg(), device=CPU)
    _two_submaps(system)
    system.graph.add_odom_edge(0, 1, np.eye(4))
    system.keyframes = [_fab_kf(0, submap_id=0), _fab_kf(1, submap_id=1)]
    system.loops = [(1, 0, np.eye(4), 0.1)]
    assert system._pending_opt is None
    system._drain()  # no pending scans: still flushes loop factors
    assert system._n_loop_factors == 1
    assert system._pending_opt is not None


@pytest.mark.slow
def test_predict_imu_rate_tracks_gt(distorted_sequence):
    """Between scan-rate updates, the IMU-rate predictions' increments
    track ground-truth motion, and the stream starts at the fused nav
    state's position."""
    scans, gt = distorted_sequence
    cfg = _lio_cfg()
    system = slam.SemanticSlam(cfg, device=CPU)
    errs, starts = [], []
    for i, s in enumerate(scans[:16]):
        system.process_scan(
            driver.pad_scan(s.points[s.valid], cfg, scan_start=i * 0.1),
            gt_labels=s.labels[s.valid], timestamp=i * 0.1,
            imu_time=s.imu_time + i * 0.1, imu_gyro=s.gyro,
            imu_accel=s.accel)
        if i < 8 or i + 1 >= len(scans):
            continue  # let the velocity/bias estimate settle first
        pred = system.predict_imu_rate(s.imu_time + i * 0.1, s.gyro,
                                       s.accel).numpy()
        frac = np.clip(np.asarray(s.imu_time) / 0.1, 0.0, 1.5)
        gt_pos = (gt[i][None, 3:] * (1 - frac[:, None])
                  + gt[i + 1][None, 3:] * frac[:, None])
        dp_pred = pred[:, 3:6] - pred[0, 3:6]
        dp_gt = gt_pos[:len(pred)] - gt_pos[0]
        errs.append(np.linalg.norm(dp_pred - dp_gt, axis=1).max())
        starts.append(np.linalg.norm(
            pred[0, 3:6] - system.fstate.imu.p.numpy()))
    assert len(errs) >= 6
    assert float(np.median(errs)) < 0.12, f"median {np.median(errs):.3f}"
    assert float(np.max(starts)) < 1e-3


# ------------------------------------------------------------------------
# test_round5.py
# ------------------------------------------------------------------------


def test_pad_scan_gyro_only_accel_is_gravity_neutral():
    """A gyro-only window carries gravity-neutral accel rows, as
    pad_imu_window does."""
    cfg = SlamConfig()
    it = np.arange(8, dtype=np.float32) * 0.01
    ig = np.full((8, 3), 0.1, np.float32)
    sin = driver.pad_scan(np.zeros((10, 4), np.float32), cfg, imu_time=it,
                          imu_gyro=ig)
    ia = sin.imu_accel.numpy()
    assert np.allclose(ia[:8, 2], cfg.imu.gravity)
    assert np.allclose(ia[:8, :2], 0.0)
    _t, _g, ia2, _v = driver.pad_imu_window(cfg, it, ig, None)
    assert np.allclose(ia, ia2)


def test_pad_scan_routes_explicit_accel():
    cfg = SlamConfig()
    it = np.arange(4, dtype=np.float32) * 0.01
    ia = np.tile(np.array([[1.0, 2.0, 3.0]], np.float32), (4, 1))
    sin = driver.pad_scan(np.zeros((10, 4), np.float32), cfg, imu_time=it,
                          imu_gyro=np.zeros((4, 3), np.float32),
                          imu_accel=ia)
    assert np.allclose(sin.imu_accel.numpy()[:4], ia)
    assert np.allclose(sin.imu_accel.numpy()[4:, 2], cfg.imu.gravity)


def _make_pre(cfg_imu, n=12):
    t = torch.arange(n, dtype=torch.float64) * 0.01
    a = torch.zeros((n, 3), dtype=torch.float64)
    a[:, 2] = cfg_imu.gravity
    z = torch.zeros(3, dtype=torch.float64)
    return pi.preintegrate(t, torch.zeros((n, 3), dtype=torch.float64), a,
                           torch.ones(n, dtype=torch.bool), z, z, cfg_imu)


def test_clamped_two_window_update_keeps_prior_marginal():
    """When the MAP step saturates the safety clamps, P_bias does not
    contract as if the full step was applied; a consistent step does."""
    cfg_imu = ImuConfig(use_imu=True)
    pre = _make_pre(cfg_imu)
    state = pi.init_imu_state(cfg_imu)

    def pose_x(x):
        p = torch.zeros(6, dtype=torch.float64)
        p[3] = x
        return p

    zero3 = torch.zeros(3, dtype=torch.float64)
    new, _v1 = pi.velocity_bias_update2(
        state, pre, pre, pose_x(0.0), pose_x(50.0), pose_x(200.0), zero3,
        cfg_imu)
    assert float(torch.max(torch.abs(new.ba))) >= 0.2 - 1e-6
    assert float(torch.trace(new.P_bias)) >= float(
        torch.trace(state.P_bias)) * 0.999
    dp = pre.delta_p.numpy()
    g = np.array([0, 0, -cfg_imu.gravity])
    dt = float(pre.delta_t)
    p1 = dp + 0.5 * g * dt * dt
    p2 = p1 + pre.delta_v.numpy() * dt + dp + 1.5 * g * dt * dt
    nom, _ = pi.velocity_bias_update2(
        state, pre, pre, torch.zeros(6, dtype=torch.float64),
        _f64(np.concatenate([np.zeros(3), p1])),
        _f64(np.concatenate([np.zeros(3), p2])), zero3, cfg_imu)
    assert float(torch.max(torch.abs(nom.ba))) < 0.2 - 1e-6
    assert float(torch.trace(nom.P_bias)) < float(torch.trace(state.P_bias))


def _close_submaps(system, n_submaps, kf_per=3):
    """Drive keyframes through the collector and _on_submap, as
    _on_keyframe does, cutting a submap every kf_per keyframes."""
    idx = len(system.keyframes)
    for _ in range(n_submaps):
        for _k in range(kf_per):
            kf = _fab_kf(idx, t=idx * 0.1)
            system.keyframes.append(kf)
            system.collector._cur_kfs.append(kf)
            idx += 1
        system._on_submap(system.collector._finish())


def test_keyframe_clouds_released_after_submap_close():
    cfg = tiny_cfg()
    assert cfg.submap.release_after_submaps == 2
    system = slam.SemanticSlam(cfg, device=CPU)
    _close_submaps(system, 4)
    for s_idx, s in enumerate(system.collector.submaps):
        for k in s.kf_indices:
            kf = system.keyframes[k]
            if s_idx < 2:
                assert (kf.released and kf.surf_xyz is None
                        and kf.clouds is None)
            else:
                assert not kf.released and kf.surf_xyz is not None
    # poses and timestamps survive (loop gating and the GPS index)
    assert system.keyframes[0].pose_init[0, 3] == 0.0
    assert system.keyframes[0].timestamp == 0.0


def test_release_disabled_when_zero():
    cfg = tiny_cfg()
    cfg = cfg.replace(submap=dataclasses.replace(cfg.submap,
                                                 release_after_submaps=0))
    system = slam.SemanticSlam(cfg, device=CPU)
    _close_submaps(system, 4)
    assert all(not kf.released for kf in system.keyframes)


def test_gps_index_is_incremental():
    """The keyframe-timestamp index grows at each close, not by a full
    rebuild per call."""
    system = slam.SemanticSlam(tiny_cfg(), device=CPU)
    _close_submaps(system, 2)
    assert system._indexed_submaps == 2
    n0 = len(system._kf_time_index)
    assert n0 == sum(len(s.kf_indices) for s in system.collector.submaps)
    assert system.add_gps(np.array([1.0, 0, 0]), np.full(3, 0.01),
                          timestamp=0.1)
    assert len(system.graph.priors) >= 1
    _close_submaps(system, 1)
    assert system._indexed_submaps == 3
    assert len(system._kf_time_index) > n0


def test_class_merge_threads_per_point_weights():
    """_merge_stacked_classes carries each point's weight through the
    voxel merge."""
    rng = np.random.default_rng(3)
    K, Q, C = 2, 64, 256
    xyz = rng.uniform(-20, 20, (K, 5, Q, 3)).astype(np.float32)
    mask = rng.uniform(size=(K, 5, Q)) < 0.8

    def wf(p):
        return 0.5 + (np.abs(p[..., 0]) % 1.3)

    poses = np.broadcast_to(np.eye(4, dtype=np.float32), (K, 4, 4)).copy()
    out, om, ow = sm._merge_stacked_classes(
        torch.from_numpy(poses), torch.from_numpy(xyz),
        torch.from_numpy(mask), torch.from_numpy(wf(xyz).astype(np.float32)),
        0.01, C)
    out, om, ow = out.numpy(), om.numpy(), ow.numpy()
    assert om.any()
    np.testing.assert_allclose(ow[om], wf(out[om]), atol=1e-5)


def test_stage3_per_point_weights_match_replica():
    """Submap registration on merged class clouds with per-point weights
    agrees with replica.scan_to_submap_semantic on the same weighted
    points, and both find the true pose."""
    rng = np.random.default_rng(21)
    map_c, map_s = _structured_scene(rng)
    true_pose = np.array([0.003, -0.004, 0.018, 0.25, -0.15, 0.04])
    Ti = np.linalg.inv(replica.pose_to_matrix(true_pose))
    cur_c = replica.transform_points(Ti, map_c[rng.choice(
        len(map_c), 250, replace=False)])
    cur_s = replica.transform_points(Ti, map_s[rng.choice(
        len(map_s), 1200, replace=False)])

    def wf(p):
        return (0.6 + (np.abs(p[:, 0] + p[:, 1]) % 0.9)).astype(np.float32)

    cfg = SlamConfig()
    cfg = cfg.replace(
        submap=dataclasses.replace(cfg.submap, refine_surf_leaf=0.01,
                                   keyframe_class_capacity=2048,
                                   class_capacity=8192),
        voxel=dataclasses.replace(cfg.voxel, submap_corner_leaf=0.01),
        sensor=dataclasses.replace(cfg.sensor, max_raw_points=4096))

    def kf_cls(pts_c, pts_s):
        Q = cfg.submap.keyframe_class_capacity
        xyz = np.zeros((5, Q, 3), np.float32)
        msk = np.zeros((5, Q), bool)
        w = np.ones((5, Q), np.float32)
        for cat, pts in ((slam._POLE, pts_c), (slam._GND, pts_s)):
            n = min(len(pts), Q)
            xyz[cat, :n] = pts[:n]
            msk[cat, :n] = True
            w[cat, :n] = wf(pts[:n])
        return xyz, msk, w

    h1 = kf_cls(cur_c[::2], cur_s[::2])
    h2 = kf_cls(cur_c[1::2], cur_s[1::2])
    poses = torch.eye(4).expand(2, 4, 4).contiguous()
    mx, mm, mw = sm._merge_stacked_classes(
        poses, *(torch.from_numpy(np.stack([h1[k], h2[k]]))
                 for k in range(3)), 0.01, cfg.submap.class_capacity)
    C = cfg.submap.class_capacity
    pxyz = np.zeros((5, C, 3), np.float32)
    pmsk = np.zeros((5, C), bool)
    pxyz[slam._POLE, :len(map_c)] = map_c
    pmsk[slam._POLE, :len(map_c)] = True
    pxyz[slam._GND, :len(map_s)] = map_s
    pmsk[slam._GND, :len(map_s)] = True
    T_ref = slam._register_submaps_sem(
        torch.from_numpy(pxyz), torch.from_numpy(pmsk), mx, mm, mw,
        torch.eye(4), torch.full((3,), -100.0), torch.full((3,), 100.0),
        cfg)
    port_pose = np.asarray(replica.matrix_to_pose(
        T_ref.numpy().astype(np.float64)))
    rep_pose = replica.scan_to_submap_semantic(
        np.zeros(6), cur_c, wf(cur_c), cur_s, wf(cur_s), map_c, map_s, cfg,
        max_iter=cfg.matching.max_iterations_submap2submap)
    np.testing.assert_allclose(rep_pose, true_pose, atol=8e-3)
    np.testing.assert_allclose(port_pose, true_pose, atol=8e-3)
    np.testing.assert_allclose(port_pose, rep_pose, atol=1e-2)


# ------------------------------------------------------------------------
# test_epsc_naive_replica.py
# ------------------------------------------------------------------------


def _port_descriptors(cloud):
    t = [torch.from_numpy(np.asarray(a)) for a in cloud]
    return epsc.compute_descriptors(*t, LoopClosureConfig())


def test_descriptor_grids_match_naive_loops(cloud):
    d = _port_descriptors(cloud)
    sc, isc, epsc_g, sepsc, ssc, fepsc = _naive_descriptors(
        *cloud, LoopClosureConfig())
    for got, want in ((d.sc, sc), (d.isc, isc), (d.epsc, epsc_g),
                      (d.sepsc, sepsc), (d.ssc, ssc), (d.fepsc, fepsc)):
        np.testing.assert_array_equal(got.numpy(), want)
    assert np.count_nonzero(sc) > 50
    assert np.count_nonzero(epsc_g) > 50
    assert np.count_nonzero(ssc) > 20


def test_signature_matches_naive_loops(cloud):
    sem_xyz, _si, sem_lab, sem_val = cloud[:4]
    sig = _port_descriptors(cloud).signature.numpy()
    count, members = _naive_signature(sem_xyz, sem_lab, sem_val)
    np.testing.assert_array_equal(sig[:, 0], count)
    assert count.sum() > 100
    for sec in range(epsc._SIG_SECTORS):
        if count[sec] == 0:
            assert sig[sec, 1] == 0 and sig[sec, 2] == 0 and sig[sec, 3] == 0
            continue
        got = (round(float(sig[sec, 1]), 4), round(float(sig[sec, 2]), 4),
               float(sig[sec, 3]))
        cands = {(round(x, 4), round(y, 4), lab)
                 for (x, y, lab) in members[sec]}
        assert got in cands, f"sector {sec}: {got} not in {cands}"
