"""Port parity of the EPSC loop detector (loop/epsc.py) against
lis_slam_tpu/loop/epsc.py, on clouds rendered from the plaza world along
the bench's 10 m circle: the six descriptor families and the 360-sector
signature equal; the batched candidate scoring (signature alignment, 2-D
ICP, descriptor recomputation, +-10-sector search) within 1e-5 with the
same best candidate; the candidate gate equal.

The signature's x/y/label columns are a scatter-SET with several points
per sector: XLA leaves the winner unspecified. `test_signature_duplicate_
sector_winner` pins what the JAX package keeps on the CPU (the highest
source index), which the port keeps deterministically on any device."""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp
import torch

import lis_slam_tpu.io.synthetic as jsyn
from lis_slam_tpu.config import LoopClosureConfig as JLoopCfg
from lis_slam_tpu.loop import epsc as jepsc
from lis_slam_torch.config import DescriptorType, LoopClosureConfig
from lis_slam_torch.io import synthetic_torch
from lis_slam_torch.loop import epsc as tepsc

SCORE_ATOL = 1e-5
N_SEM, N_CORNER, N_SURF = 6000, 600, 2000


def _clouds(i, gt, world):
    """One keyframe's descriptor inputs from a 16 x 900 render."""
    s = jsyn.render_scan(world, gt[i], None, n_scan=16, horizon=900,
                         seed=400 + i, max_range=90.0)
    r = np.random.default_rng(i)
    pts = s.points[s.valid]
    lab = s.labels[s.valid].astype(np.int32)
    pick = r.permutation(len(pts))
    sem = np.zeros((N_SEM, 4), np.float32)
    slab = np.zeros(N_SEM, np.int32)
    k = min(N_SEM, len(pts))
    sem[:k], slab[:k] = pts[pick[:k]], lab[pick[:k]]
    valid = np.arange(N_SEM) < k
    pole = pts[lab == jsyn.LBL_POLE][:, :3]
    corner = np.zeros((N_CORNER, 3), np.float32)
    corner[:min(len(pole), N_CORNER)] = pole[:N_CORNER]
    surf = pts[pick[:N_SURF], :3].astype(np.float32)
    return (sem[:, :3], sem[:, 3], slab, valid, corner,
            np.arange(N_CORNER) < len(pole), surf, np.ones(N_SURF, bool))


@pytest.fixture(scope="module")
def scene():
    world = synthetic_torch.plaza_world()
    gt = jsyn.circular_trajectory(101, radius=10.0,
                                  speed=2.0 * np.pi * 10.0 / (100 * 0.1))
    orig = jsyn.hdl64_elevations
    jsyn.hdl64_elevations = lambda: np.linspace(15.0, -15.0, 16)
    try:
        clouds = {i: _clouds(i, gt, world) for i in (0, 3, 50, 97, 99)}
    finally:
        jsyn.hdl64_elevations = orig
    return gt, clouds


def _desc(mod, args, cfg, tensor):
    return mod.compute_descriptors(*(tensor(a) for a in args), cfg)


@pytest.mark.parametrize("i", [0, 50])
def test_descriptors_equal(scene, i):
    _gt, clouds = scene
    dj = _desc(jepsc, clouds[i], JLoopCfg(), jnp.asarray)
    dt = _desc(tepsc, clouds[i], LoopClosureConfig(), torch.from_numpy)
    for f in jepsc.Descriptors._fields:
        np.testing.assert_array_equal(getattr(dt, f).numpy(),
                                      np.asarray(getattr(dj, f)), err_msg=f)
    assert float(dt.fepsc.sum()) > 0 and float(dt.signature[:, 0].sum()) > 0


def test_signature_duplicate_sector_winner():
    """Three points in one sector: the JAX CPU program keeps the LAST
    (highest-index) point's x/y/label; the port does the same."""
    xyz = np.array([[5.0, 0.01, 0.0], [6.0, 0.012, 0.0], [7.0, 0.011, 0.0],
                    [0.0, 9.0, 0.0]], np.float32)
    lab = np.array([13, 18, 16, 19], np.int32)
    args = (xyz, np.ones(4, np.float32), lab, np.ones(4, bool),
            xyz[:1], np.zeros(1, bool), xyz[:1], np.zeros(1, bool))
    sj = np.asarray(_desc(jepsc, args, JLoopCfg(), jnp.asarray).signature)
    st = _desc(tepsc, args, LoopClosureConfig(), torch.from_numpy).signature
    sec = int(np.nonzero(sj[:, 0] == 3)[0][0])
    np.testing.assert_array_equal(
        sj[sec], np.array([3.0, 7.0, 0.011, 16.0], np.float32))
    np.testing.assert_array_equal(st.numpy(), sj)


@pytest.mark.parametrize("descriptor", ["fepsc", "ssc"])
def test_loop_score_batch_matches(scene, descriptor):
    """Keyframe 99 against candidates 0, 3, 97 (revisit + a near
    neighbor), padded to max_candidates as score_async pads."""
    gt, clouds = scene
    jc = JLoopCfg(descriptor=descriptor)
    tc = LoopClosureConfig(descriptor=DescriptorType(descriptor))
    ids = [0, 3, 97] + [0] * (tc.max_candidates - 3)
    cand_j = [_desc(jepsc, clouds[i], jc, jnp.asarray) for i in ids]
    cand_t = [_desc(tepsc, clouds[i], tc, torch.from_numpy) for i in ids]
    cur = clouds[99]
    yaw = (gt[99, 2] - gt[ids, 2]).astype(np.float32)
    rj = jepsc.loop_score_batch(
        jnp.stack([jepsc.select_descriptor(d, jc.descriptor)
                   for d in cand_j]),
        jnp.stack([d.signature for d in cand_j]),
        _desc(jepsc, cur, jc, jnp.asarray).signature, jnp.asarray(yaw),
        jepsc.CloudRefs(*(jnp.asarray(a) for a in cur)), jc)
    rt = tepsc.loop_score_batch(
        torch.stack([tepsc.select_descriptor(d, tc.descriptor)
                     for d in cand_t]),
        torch.stack([d.signature for d in cand_t]),
        _desc(tepsc, cur, tc, torch.from_numpy).signature,
        torch.from_numpy(yaw),
        tepsc.CloudRefs(*(torch.from_numpy(a) for a in cur)), tc)
    best_j, score_j, angle_j, t2_j, ok_j = (np.asarray(x) for x in rj)
    best_t, score_t, angle_t, t2_t, ok_t = (x.numpy() for x in rt)
    assert int(best_t) == int(best_j) and bool(ok_t) == bool(ok_j)
    assert abs(float(score_t) - float(score_j)) <= SCORE_ATOL
    assert abs(float(angle_t) - float(angle_j)) <= 1e-4
    np.testing.assert_allclose(t2_t, t2_j, atol=1e-3)
    # per-candidate alignment of the batch
    R2j, t2j, yj, okj = jepsc.global_icp_batch(
        jnp.stack([d.signature for d in cand_j]),
        _desc(jepsc, cur, jc, jnp.asarray).signature, jnp.asarray(yaw))
    R2t, t2t, yt, okt = tepsc.global_icp(
        torch.stack([d.signature for d in cand_t]),
        _desc(tepsc, cur, tc, torch.from_numpy).signature,
        torch.from_numpy(yaw))
    np.testing.assert_allclose(R2t.numpy(), np.asarray(R2j), atol=1e-4)
    np.testing.assert_allclose(t2t.numpy(), np.asarray(t2j), atol=1e-3)
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))


def test_detector_gate_and_candidate_match():
    """Gate arithmetic over a drifting revisit, and result_to_candidate."""
    r = np.random.default_rng(5)
    jd, td = jepsc.LoopDetector(JLoopCfg()), tepsc.LoopDetector(
        LoopClosureConfig())
    ang = np.linspace(0, 2.2 * np.pi, 60)
    poses = np.stack([10 * np.sin(ang), 10 * (1 - np.cos(ang)), ang], 1)
    poses[:, :2] += r.normal(0, 0.05, (60, 2))
    n_gated = 0
    for p in poses:
        gj, gt_ = jd.gate(p), td.gate(p)
        np.testing.assert_array_equal(gt_, gj)
        n_gated += len(gt_)
        jd.append(jnp.zeros((20, 80)), jnp.zeros((360, 4)), p)
        td.append(torch.zeros(20, 80), torch.zeros(360, 4), p)
    assert n_gated > 0
    fetched = (np.int32(2), np.float32(0.9), np.float32(0.3),
               np.array([1.0, -2.0], np.float32), np.bool_(True))
    ids = np.array([7, 3, 9])
    cj = jepsc.LoopDetector.result_to_candidate(ids, fetched)
    ct = tepsc.LoopDetector.result_to_candidate(ids, fetched)
    assert ct.matched_id == cj.matched_id == 9
    np.testing.assert_array_equal(ct.transform, cj.transform)


def test_add_and_detect_matches(scene):
    """add_and_detect over keyframes 0, 3, 50, 97 then the revisit 99 on
    the plaza lap: the same candidates (matched id, score within
    SCORE_ATOL, transform within 1e-3) as the JAX detector's, and a loop
    at the revisit. Five keyframes travel ~60 m, so the gate's position
    bound is widened to 5% of the travel (the default 1% is 0.6 m, and
    the revisit is 0.63 m from keyframe 0)."""
    gt, clouds = scene
    jc = dataclasses.replace(JLoopCfg(), inflation_covariance=0.05)
    tc = dataclasses.replace(LoopClosureConfig(), inflation_covariance=0.05)
    jd, td = jepsc.LoopDetector(jc), tepsc.LoopDetector(tc)
    for i in (0, 3, 50, 97, 99):
        pose = np.array([gt[i, 3], gt[i, 4], gt[i, 2]])
        cj = jd.add_and_detect(_desc(jepsc, clouds[i], jc, jnp.asarray), pose,
                               jepsc.CloudRefs(*(jnp.asarray(a)
                                                 for a in clouds[i])))
        ct = td.add_and_detect(_desc(tepsc, clouds[i], tc, torch.from_numpy),
                               pose, tepsc.CloudRefs(*(torch.from_numpy(a)
                                                       for a in clouds[i])))
        assert len(ct) == len(cj), i
        for a, b in zip(ct, cj):
            assert a.matched_id == b.matched_id
            assert abs(a.score - b.score) <= SCORE_ATOL
            np.testing.assert_allclose(a.transform, b.transform, atol=1e-3)
    assert cj and ct, "the revisit produced no loop candidate"
    assert len(td.poses) == 5
