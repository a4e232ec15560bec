"""Port parity of the front end's tensor ops: pretreatment, projection,
feature extraction and the voxel grid, against the JAX package on a
rendered HDL-64 scan at a reduced column count (450 of 1800).

Each stage gets the JAX package's own input for that stage, so a
difference shows where it starts. Integer and mask outputs must be equal;
float outputs agree to atol 1e-5.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp
import torch

from lis_slam_tpu.config import SensorConfig as JSensorConfig
from lis_slam_tpu.config import SlamConfig as JSlamConfig
from lis_slam_tpu.io import synthetic
from lis_slam_tpu.ops import features as jfeat, pretreatment as jpre
from lis_slam_tpu.ops import projection as jproj, voxel as jvox
from lis_slam_torch.config import SensorConfig, SlamConfig
from lis_slam_torch.ops import features as tfeat, pretreatment as tpre
from lis_slam_torch.ops import projection as tproj, voxel as tvox

H = 450
ATOL = 1e-5


def _t(x):
    return torch.from_numpy(np.array(x))


def _eq(t, j):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=atol, rtol=0)


@pytest.fixture(scope="module")
def cfgs():
    sensor = dict(horizon_scan=H, max_raw_points=64 * H)
    return (JSlamConfig().replace(sensor=JSensorConfig(**sensor)),
            SlamConfig().replace(sensor=SensorConfig(**sensor)))


@pytest.fixture(scope="module")
def scans(cfgs):
    """Three consecutive scans of the bench circuit, padded buffers."""
    world = synthetic.make_world(seed=5)
    gt = synthetic.circular_trajectory(4, radius=60.0, speed=8.0)
    p = cfgs[0].sensor.max_raw_points
    out = []
    for i in range(3):
        s = synthetic.render_scan(world, gt[i], None, horizon=H, seed=70 + i)
        pts = np.zeros((p, 4), np.float32)
        n = int(s.valid.sum())
        pts[:n] = s.points[s.valid]
        pts[n:n + 5] = [[np.nan, 0, 0, 0], [0.05, 0, 0, 0], [200, 0, 0, 0],
                        [0, 0, 40, 0], [5, 5, -30, 0]]  # gated out
        out.append((pts, np.arange(p) < n + 5, gt[i]))
    return out


@pytest.fixture(scope="module")
def stages(cfgs, scans):
    """The JAX package's stage outputs per scan (numpy)."""
    jcfg = cfgs[0]
    res = []
    for pts, valid, _pose in scans:
        pre = jpre.pretreat(jnp.asarray(pts), jnp.asarray(valid), jcfg.sensor)
        _img, ext = jproj.project_and_extract(
            pre.points[:, :3], pre.points[:, 3], pre.ring, pre.rel_time,
            pre.valid, jcfg.sensor, want_image=False)
        fc = jfeat.extract_features(ext, jcfg.feature)
        res.append((pre, ext, fc))
    return res


def test_pretreat_matches(cfgs, scans, stages):
    for (pts, valid, _), (pre_j, _e, _f) in zip(scans, stages):
        pre_t = tpre.pretreat(_t(pts), _t(valid), cfgs[1].sensor)
        _eq(pre_t.valid, pre_j.valid)
        _eq(pre_t.ring, pre_j.ring)
        _close(pre_t.points, pre_j.points, atol=0)
        _close(pre_t.rel_time, pre_j.rel_time)


def test_project_and_extract_matches(cfgs, stages):
    for pre_j, ext_j, _f in stages:
        _img, ext_t = tproj.project_and_extract(
            _t(pre_j.points[:, :3]), _t(pre_j.points[:, 3]), _t(pre_j.ring),
            _t(pre_j.rel_time), _t(pre_j.valid), cfgs[1].sensor)
        assert int(ext_t.count.sum()) > 1000
        for f in ("count", "mask", "col", "src"):
            _eq(getattr(ext_t, f), getattr(ext_j, f))
        for f in ("rng", "xyz", "intensity"):
            _close(getattr(ext_t, f), getattr(ext_j, f))


def test_extract_features_matches(cfgs, stages):
    for _p, ext_j, fc_j in stages:
        ext_t = tproj.ExtractedCloud(
            *(_t(getattr(ext_j, f)) for f in tproj.ExtractedCloud._fields))
        fc_t = tfeat.extract_features(ext_t, cfgs[1].feature)
        assert int(fc_t.sharp_corner_mask.sum()) > 50
        for f in tfeat.FeatureClouds._fields:
            if f.endswith("mask") or f == "surf_src":
                _eq(getattr(fc_t, f), getattr(fc_j, f))
            else:
                _close(getattr(fc_t, f), getattr(fc_j, f))


def test_greedy_selection_raises(cfgs, stages):
    """Formerly the check that greedy selection raised; it is ported now:
    the reference's pick-and-suppress replica (extract_features
    greedy=True) must come out equal to the JAX package's on every scan."""
    for _p, ext_j, _f in stages:
        fc_j = jfeat.extract_features(ext_j, cfgs[0].feature, greedy=True)
        ext_t = tproj.ExtractedCloud(
            *(_t(getattr(ext_j, f)) for f in tproj.ExtractedCloud._fields))
        fc_t = tfeat.extract_features(ext_t, cfgs[1].feature, greedy=True)
        assert int(fc_t.corner_mask.sum()) > 50
        assert int(fc_t.sharp_surf_mask.sum()) > 50
        for f in tfeat.FeatureClouds._fields:
            if f.endswith("mask") or f == "surf_src":
                _eq(getattr(fc_t, f), getattr(fc_j, f))
            else:
                _close(getattr(fc_t, f), getattr(fc_j, f), atol=0)


@pytest.mark.parametrize("leaf", [0.4, 1.2])
def test_voxel_keys_and_downsample_match(stages, leaf):
    fc = stages[0][2]
    pts, mask = np.asarray(fc.surf_xyz), np.asarray(fc.surf_mask)
    _eq(tvox._voxel_key(_t(pts), _t(mask), leaf),
        np.asarray(jvox._voxel_key(jnp.asarray(pts), jnp.asarray(mask),
                                   leaf)).astype(np.int64))
    _eq(tvox._voxel_key_morton(_t(pts), _t(mask), leaf),
        np.asarray(jvox._voxel_key_morton(jnp.asarray(pts),
                                          jnp.asarray(mask), leaf)
                   ).astype(np.int64))
    for cap in (2048, 512):  # 512 overflows at the 0.4 m leaf
        out_j = jvox.voxel_downsample(jnp.asarray(pts), jnp.asarray(mask),
                                      leaf, cap)
        out_t = tvox.voxel_downsample(_t(pts), _t(mask), leaf, cap)
        _eq(out_t[1], out_j[1])
        assert int(out_t[2]) == int(out_j[2])
        _close(out_t[0], out_j[0], atol=0)


@pytest.mark.parametrize("anchor", ["first", "newest"])
def test_voxel_merge_aged_matches(cfgs, scans, stages, anchor):
    """Three keyframes into a small map with a two-keyframe window: dedup,
    anchoring, ageing and expiry all come out equal."""
    cap, window, leaf = 32768, 2, 0.4
    mj = (jnp.zeros((cap, 3)), jnp.full((cap,), -(10**9), jnp.int32),
          jnp.zeros(cap, bool))
    mt = tuple(_t(np.asarray(a)) for a in mj)
    for kf, ((_p, _v, pose), (_pre, _e, fc)) in enumerate(zip(scans, stages)):
        # world-frame cloud, shifted so consecutive keyframes overlap
        pts = np.asarray(fc.surf_xyz) + np.asarray(pose[3:], np.float32)
        mask = np.asarray(fc.surf_mask)
        mj = jvox.voxel_merge_aged(jnp.asarray(pts), jnp.asarray(mask), *mj,
                                   jnp.int32(kf), window, leaf, cap,
                                   anchor=anchor)
        mt = tvox.voxel_merge_aged(_t(pts), _t(mask), *mt, kf, window, leaf,
                                   cap, anchor=anchor)
        _eq(mt[2], mj[2])
        _eq(mt[1], mj[1])
        _close(mt[0], mj[0], atol=0)
    assert 0 < int(mt[2].sum()) < cap


def test_compact_masked_matches():
    r = np.random.default_rng(2)
    pts = r.normal(size=(300, 3)).astype(np.float32)
    mask = r.uniform(size=300) > 0.5
    for cap in (256, 64):
        bj, mj = jvox.compact_masked(jnp.asarray(pts), jnp.asarray(mask), cap)
        bt, mt = tvox.compact_masked(_t(pts), _t(mask), cap)
        _eq(mt, mj)
        _close(bt, bj, atol=0)
