"""Batched multi-sequence replay (lis_slam_torch/parallel/batched.py)
against the port's own single-sequence uniform step, the lanes of the
kernels' plain versions against one-lane calls, and the batched state
conversion; one JAX comparison (a vmap compile of the batched step) is
marked slow.

Scans: rendered HDL-64 (450 of 1800 columns) on the circuit of
tests/test_torch_odometry.py, default configuration, on the CPU.
"""

import dataclasses

import numpy as np
import pytest
import torch

from lis_slam_torch.config import SensorConfig, SlamConfig
from lis_slam_torch.io import synthetic
from lis_slam_torch.ops import gn_cuda, knn_cuda
from lis_slam_torch.parallel import batched
from lis_slam_torch.pipeline import convert, driver, odometry

H = 450
N_SCANS = 4
LANE_ATOL = 5e-3  # m, a lane against the single-lane uniform replay
# m, the port's replay against the JAX package's, both free-running (the
# card's bar for two GN backends' free-running runs, chip_smoke.py)
FREE_RUN_ATOL = 0.02


def _cfg(kf_every=1):
    cfg = SlamConfig().replace(sensor=SensorConfig(horizon_scan=H,
                                                   max_raw_points=64 * H))
    return cfg.replace(runtime=dataclasses.replace(
        cfg.runtime, batched_kf_every=kf_every))


@pytest.fixture(scope="module")
def scans():
    world = synthetic.make_world(seed=5)
    gt = synthetic.circular_trajectory(N_SCANS + 3, radius=60.0, speed=8.0)
    out = []
    for i in range(N_SCANS + 2):
        s = synthetic.render_scan(world, gt[i], None, horizon=H, seed=50 + i)
        out.append(s.points[s.valid])
    return out, gt


def _single_uniform(clouds, cfg):
    state = odometry.init_state(cfg, "cpu")
    poses = []
    for c in clouds:
        state, out = odometry.odom_step_uniform(
            state, driver.pad_scan(c, cfg), cfg)
        poses.append(out.pose.numpy())
    return np.asarray(poses)


@pytest.fixture(scope="module")
def single(scans):
    clouds, _gt = scans
    return {s: _single_uniform(clouds[s:s + N_SCANS], _cfg()) for s in (0, 2)}


def test_identical_lanes_bit_equal(scans):
    clouds, _gt = scans
    poses = batched.replay_batched([clouds[:N_SCANS]] * 2, _cfg(),
                                   device="cpu")
    assert poses.shape == (2, N_SCANS, 6)
    assert np.array_equal(poses[0], poses[1])


def test_distinct_lanes_match_single_lane_replay(scans, single):
    """B = 3 lanes, two starts: each lane within LANE_ATOL of the port's
    single-sequence uniform replay at batched_kf_every=1."""
    clouds, _gt = scans
    starts = (0, 2, 0)
    poses = batched.replay_batched(
        [clouds[s:s + N_SCANS] for s in starts], _cfg(), device="cpu")
    for b, s in enumerate(starts):
        np.testing.assert_allclose(poses[b][:, 3:], single[s][:, 3:],
                                   atol=LANE_ATOL, err_msg=f"lane {b}")
        np.testing.assert_allclose(poses[b][:, :3], single[s][:, :3],
                                   atol=5e-4, err_msg=f"lane {b}")


def test_keyframe_cadence(scans, single):
    """batched_kf_every=2 quantizes keyframe timing: within 0.3 m of the
    per-scan-merge replay (the JAX package's bound,
    tests/test_parallel.py:test_batched_kf_cadence)."""
    clouds, _gt = scans
    poses = batched.replay_batched([clouds[:N_SCANS]], _cfg(kf_every=2),
                                   device="cpu")
    assert np.abs(poses[0] - single[0]).max() < 0.3


def test_batched_step_outputs_and_gated_merge(scans):
    """One batched step: OdomOutput fields are (B,) tensors; with
    allow_kf=False no lane keyframes and the maps do not change."""
    clouds, _gt = scans
    cfg = _cfg()
    states = batched.batched_init_state(cfg, 2, "cpu")
    scan = batched.stack_scans([driver.pad_scan(c, cfg) for c in clouds[:2]])
    assert scan.vel_valid.shape == (2,) and scan.imu_time is None
    states, out = batched.batched_odom_step(states, scan, cfg)
    assert out.is_keyframe.shape == (2,) and bool(out.is_keyframe.all())
    assert out.iterations.dtype == torch.int32
    scan = batched.stack_scans([driver.pad_scan(c, cfg)
                                for c in clouds[1:3]])
    before = states
    states, out = batched.batched_odom_step(states, scan, cfg,
                                            allow_kf=False)
    assert not bool(out.is_keyframe.any())
    for f in ("map_corner", "map_surf", "kf_count", "last_kf_pose"):
        assert torch.equal(getattr(states, f), getattr(before, f)), f
    with pytest.raises(ValueError):
        batched.stack_scans([driver.pad_scan(clouds[0], cfg),
                             driver.pad_scan(clouds[1], cfg)._replace(
                                 imu_rpy=torch.zeros(3))])


def test_batched_state_conversion_round_trip(scans):
    clouds, _gt = scans
    cfg = _cfg()
    states = batched.batched_init_state(cfg, 2, "cpu")
    scan = batched.stack_scans([driver.pad_scan(c, cfg) for c in clouds[:2]])
    states, _ = batched.batched_odom_step(states, scan, cfg)
    lanes = convert.odom_states_to_numpy(states)
    assert len(lanes) == 2
    back = convert.odom_states_from_numpy(lanes)
    for f in odometry.OdomState._fields:
        a, b = getattr(states, f), getattr(back, f)
        assert a.dtype == b.dtype and torch.equal(a, b), f
    one = convert.odom_state_from_numpy(lanes[1])
    assert torch.equal(one.map_surf, states.map_surf[1])


def test_kernel_lanes_plain_match_one_lane_calls():
    """knn_lanes and gn_iteration_lanes on the CPU: each lane equal to the
    one-lane call on its own inputs (the kernels' lanes are held to their
    one-lane launches on the card, tests/test_torch_kernels_cuda.py)."""
    r = np.random.default_rng(4)
    b, q, n, k = 3, 200, 1500, 8
    query = torch.from_numpy(r.uniform(-5, 5, (b, q, 3)).astype(np.float32))
    ref = torch.from_numpy(r.uniform(-5, 5, (b, n, 3)).astype(np.float32))
    mask = torch.from_numpy(r.uniform(size=(b, n)) > 0.3)
    d, i, xyz = knn_cuda.knn_lanes(query, ref, mask, k=k, max_sq_dist=4.0)
    for lane in range(b):
        d1, i1, x1 = knn_cuda.knn(query[lane], ref[lane], mask[lane], k=k,
                                  max_sq_dist=4.0)
        assert torch.equal(d[lane], d1) and torch.equal(i[lane], i1)
        assert torch.equal(xyz[lane], x1)
    cfg = SlamConfig().matching
    poses = torch.from_numpy(r.normal(0, 0.05, (b, 6)).astype(np.float32))
    from lis_slam_torch.ops import gn_solve

    rows = gn_solve.scalar_rows_plain(poses, cfg)
    ok = d < 4.0
    qmask = torch.from_numpy(r.uniform(size=(b, q)) > 0.1)
    hg = gn_cuda.gn_iteration_lanes(rows, query, qmask, xyz, ok, query,
                                    qmask, xyz, ok, None, None, k)
    for lane in range(b):
        one = gn_cuda.gn_iteration_vec(
            poses[lane], query[lane], qmask[lane], xyz[lane], ok[lane],
            query[lane], qmask[lane], xyz[lane], ok[lane], None, None, cfg,
            k)
        torch.testing.assert_close(hg[lane], one, rtol=1e-6, atol=1e-3)
        assert int(hg[lane, 42]) == int(one[42]) > 0


@pytest.mark.slow
def test_replay_batched_matches_jax(scans):
    """The JAX package's vmapped replay_batched on the same three lanes,
    batched_kf_every=1: every lane's positions within FREE_RUN_ATOL and
    angles within 2e-3 rad. Free-running replays, unlike the same-state
    steps of test_torch_scheduled.py: at this width float32 rounding of
    the surf rows with nearly collinear neighbours moves H by ~1%, and the
    two packages' tracks drift apart by about a centimetre in four
    scans."""
    pytest.importorskip("jax")
    from lis_slam_tpu.config import SensorConfig as JSensorConfig
    from lis_slam_tpu.config import SlamConfig as JSlamConfig
    from lis_slam_tpu.parallel import batched as jbatched
    from lis_slam_tpu.pipeline import driver as jdriver

    clouds, _gt = scans
    jcfg = JSlamConfig().replace(sensor=JSensorConfig(
        horizon_scan=H, max_raw_points=64 * H))
    jcfg = jcfg.replace(runtime=dataclasses.replace(jcfg.runtime,
                                                    batched_kf_every=1))
    starts = (0, 2, 1)
    seqs = [clouds[s:s + N_SCANS] for s in starts]
    ref = jbatched.replay_batched(
        [[jdriver.pad_scan(c, jcfg) for c in seq] for seq in seqs], jcfg)
    poses = batched.replay_batched(seqs, _cfg(), device="cpu")
    np.testing.assert_allclose(poses[..., 3:], ref[..., 3:],
                               atol=FREE_RUN_ATOL)
    np.testing.assert_allclose(poses[..., :3], ref[..., :3], atol=2e-3)
