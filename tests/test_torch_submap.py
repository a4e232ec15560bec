"""Port parity of the submap manager (mapping/submap.py) against
lis_slam_tpu/mapping/submap.py: bbox helpers, the map-based dynamic
removal (kernel K1's plain version at k=1, including an empty map that
must come back +inf and keep every candidate), and the SubMapCollector
fed the same keyframes: the same cut sequence, and every merged cloud,
mask and per-point weight bit-equal. The JAX collector pads the member
count to buckets (4/8/12/16) for its compiles; the port merges exactly
the members, so the equality also shows the padding changes nothing."""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp
import torch

from lis_slam_tpu.config import SubMapConfig as JSubMapConfig
from lis_slam_tpu.mapping import submap as jsm
from lis_slam_tpu.utils import se3_np
from lis_slam_torch.config import SubMapConfig
from lis_slam_torch.mapping import submap as tsm


def _cloud(r, n, spread=25.0, frac=0.8):
    pts = r.uniform(-spread, spread, (n, 3)).astype(np.float32)
    return pts, r.uniform(size=n) < frac


def test_bbox_helpers_equal():
    r = np.random.default_rng(0)
    pts, mask = _cloud(r, 3000)
    np.testing.assert_array_equal(
        tsm.masked_bbox(torch.from_numpy(pts), torch.from_numpy(mask)).numpy(),
        np.asarray(jsm.masked_bbox(jnp.asarray(pts), jnp.asarray(mask))))
    empty = np.zeros(3000, bool)
    bb = tsm.masked_bbox(torch.from_numpy(pts), torch.from_numpy(empty))
    assert np.isinf(bb.numpy()).all()
    lo, hi = np.array([-5, -10, -3], np.float32), np.array([8, 4, 9],
                                                           np.float32)
    for delete in (False, True):
        np.testing.assert_array_equal(
            tsm.bbox_mask(torch.from_numpy(pts), torch.from_numpy(mask),
                          torch.from_numpy(lo), torch.from_numpy(hi),
                          delete).numpy(),
            np.asarray(jsm.bbox_mask(jnp.asarray(pts), jnp.asarray(mask),
                                     jnp.asarray(lo), jnp.asarray(hi),
                                     delete)))
    assert jsm.judge_new_submap(3.0, 0.5, 25, JSubMapConfig()) == \
        tsm.judge_new_submap(3.0, 0.5, 25, SubMapConfig())


@pytest.mark.parametrize("empty_map", [False, True])
def test_dynamic_removal_mask_equal(empty_map):
    """Candidates at graded distances from a map: all three gates (near,
    min, max) and the center radius are exercised."""
    r = np.random.default_rng(1)
    map_pts, map_mask = _cloud(r, 4000, spread=20.0, frac=0.7)
    if empty_map:
        map_mask[:] = False
    base = map_pts[r.integers(0, 4000, 1500)]
    feat = (base + r.normal(0, 1, (1500, 1)) * r.normal(0, 1.5, (1500, 3))
            ).astype(np.float32)
    feat = np.concatenate([feat, r.uniform(-60, 60, (300, 3)).astype(
        np.float32)])
    fmask = r.uniform(size=len(feat)) > 0.1
    center = np.array([2.0, -3.0, 0.0], np.float32)
    args = (30.0, 0.1, 1.0, 10.0)
    kj = jsm.dynamic_removal_mask(
        jnp.asarray(feat), jnp.asarray(fmask), jnp.asarray(map_pts),
        jnp.asarray(map_mask), jnp.asarray(center),
        *(jnp.float32(a) for a in args))
    kt = tsm.dynamic_removal_mask(
        torch.from_numpy(feat), torch.from_numpy(fmask),
        torch.from_numpy(map_pts), torch.from_numpy(map_mask),
        torch.from_numpy(center), *args)
    np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))
    if empty_map:
        np.testing.assert_array_equal(kt.numpy(), fmask)
    else:
        assert 0 < int(kt.sum()) < int(fmask.sum())


def _keyframes(n=27, seed=2):
    """n keyframes along an arc: random sensor-frame clouds (corner, surf,
    5 class clouds with weights), poses advancing 0.9 m and 0.05 rad."""
    r = np.random.default_rng(seed)
    kfs = []
    for i in range(n):
        pose = np.array([0.0, 0.0, 0.05 * i, 0.9 * i, 0.1 * i, 0.0])
        T = se3_np.pose_to_matrix(pose).astype(np.float32)
        c, cm = _cloud(r, 512)
        s, smk = _cloud(r, 2048)
        cx = r.uniform(-25, 25, (5, 256, 3)).astype(np.float32)
        cxm = r.uniform(size=(5, 256)) < 0.6
        cw = r.uniform(0.5, 2.0, (5, 256)).astype(np.float32)
        kfs.append((T, c, cm, s, smk, cx, cxm, cw))
    return kfs


def _run(mod, tensor, cfg, kfs):
    col = mod.SubMapCollector(cfg)
    col.merge_classes = True
    closed = []
    for i, (T, c, cm, s, smk, cx, cxm, cw) in enumerate(kfs):
        kf = mod.Keyframe(
            index=i, pose_init=T, pose_opt=T.copy(),
            clouds=mod.ClassClouds(tensor(cx), tensor(cxm), tensor(cw)),
            corner_xyz=tensor(c), corner_mask=tensor(cm),
            surf_xyz=tensor(s), surf_mask=tensor(smk))
        done = col.add_keyframe(kf)
        if done is not None:
            closed.append(i)
    tail = col.flush()
    assert tail is not None
    return col, closed


def test_collector_cuts_and_merges_bit_equal():
    kfs = _keyframes()
    jcfg = dataclasses.replace(JSubMapConfig(), translation_max=6.0,
                               frames_size=9, corner_capacity=8192,
                               surf_capacity=16384, class_capacity=2048)
    tcfg = SubMapConfig(**dataclasses.asdict(jcfg))
    jc, jclosed = _run(jsm, jnp.asarray, jcfg, kfs)
    tc, tclosed = _run(tsm, torch.from_numpy, tcfg, kfs)
    assert tclosed == jclosed and len(tclosed) >= 3
    assert len(tc.submaps) == len(jc.submaps)
    sizes = set()
    for a, b in zip(tc.submaps, jc.submaps):
        assert a.kf_indices == b.kf_indices
        sizes.add(len(a.kf_indices))
        np.testing.assert_array_equal(a.pose_init, b.pose_init)
        for f in ("corner_xyz", "corner_mask", "surf_xyz", "surf_mask",
                  "class_xyz", "class_mask", "class_w", "bbox_dev"):
            np.testing.assert_array_equal(
                getattr(a, f).numpy(), np.asarray(getattr(b, f)), err_msg=f)
        for ra, rb in zip(a.kf_rel_poses, b.kf_rel_poses):
            np.testing.assert_array_equal(ra, rb)
    # member counts that the JAX collector pads (to 4/8/12) and one it
    # does not
    assert sizes & {3, 5, 6, 7, 9, 10, 11}, sizes


def test_keyframe_release():
    T, c, cm, s, smk, cx, cxm, cw = _keyframes(1)[0]
    kf = tsm.Keyframe(index=0, pose_init=T, pose_opt=T,
                      clouds=tsm.ClassClouds(torch.from_numpy(cx),
                                             torch.from_numpy(cxm)),
                      corner_xyz=torch.from_numpy(c),
                      corner_mask=torch.from_numpy(cm),
                      surf_xyz=torch.from_numpy(s),
                      surf_mask=torch.from_numpy(smk))
    assert not kf.released
    kf.release_clouds()
    assert kf.released and kf.clouds is None and kf.corner_xyz is None
