"""Port parity of the semantic inference path (ops/projection.py's range
image, semantic/fusion.py, semantic/inference.py, and slam_step's "infer"
mode) against the JAX package, with the in-repo slim checkpoint (the same
file in both packages, pinned by tests/test_torch_host.py) in bf16, as
SemanticSlam runs it.

- The range image of project_and_extract(want_image=True): bit-equal.
- infer_labels on a rendered HDL-64 scan: labels equal on >= 99.5% of the
  masked pixels (bf16 logits round differently in the two frameworks),
  category, weight and confidence consistent; label_images,
  category_mask, labels_to_rgb and dynamic_mask exactly.
- infer_scan_labels at 64 x 1800: per-point labels equal on >= 99.5% of
  the valid points, accuracy against ground truth > 0.8 in both packages;
  infer_winner_labels (slam_step's, on the front end's projection) equal
  to it on the pixel winners, 0 elsewhere.
- One slam_step keyframe in "infer" mode from a carried JAX FusedState:
  front-end pose as the gt-label test (5e-3 m / 5e-4 rad), refined pose
  2e-3 m, lab_surf equal on >= 99% of the surf slots, class cloud sizes
  within 1%.
- A short SemanticSlam run with inferred labels within 1.5 x the
  gt-label run's ATE + 0.03 m (the JAX package's own bar; `slow`, as its
  counterpart).
"""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")

import jax
import jax.numpy as jnp
import torch

from lis_slam_tpu.config import SensorConfig as JSensorConfig
from lis_slam_tpu.config import SlamConfig as JSlamConfig
from lis_slam_tpu.io import synthetic as jsyn
from lis_slam_tpu.ops import pretreatment as jpre, projection as jproj
from lis_slam_tpu.pipeline import driver as jdriver, slam as jslam
from lis_slam_tpu.semantic import fusion as jfusion
from lis_slam_tpu.semantic import inference as jinf
from lis_slam_torch.config import SensorConfig, SlamConfig
from lis_slam_torch.ops import pretreatment, projection
from lis_slam_torch.pipeline import convert, driver, slam, trajectory
from lis_slam_torch.semantic import fusion, inference

from _torch_plaza import render_plaza, tiny_cfgs

LABEL_AGREE = 0.995  # bf16 logits: near-ties flip in either framework
POS_ATOL, ANG_ATOL = 5e-3, 5e-4  # the front-end step's bounds
REFINED_ATOL = 2e-3


@pytest.fixture(scope="module")
def hdl64():
    """A rendered HDL-64 scan of an unseen world, the full-width configs
    of both packages and their checkpoint-backed inference wrappers."""
    jcfg = JSlamConfig().replace(sensor=JSensorConfig(max_raw_points=64 * 1800))
    tcfg = SlamConfig().replace(sensor=SensorConfig(max_raw_points=64 * 1800))
    scan = jsyn.render_scan(jsyn.make_world(seed=31),
                            np.array([0, 0, 0.7, 5.0, -3.0, 1.8]), seed=77)
    return (scan, (jcfg, jinf.SemanticInference(jcfg)),
            (tcfg, inference.SemanticInference(tcfg, device="cpu")))


def _images(scan, jcfg, tcfg):
    pj = jpre.pretreat(jnp.asarray(scan.points), jnp.asarray(scan.valid),
                       jcfg.sensor)
    img_j, _ = jproj.project_and_extract(
        pj.points[:, :3], pj.points[:, 3], pj.ring, pj.rel_time, pj.valid,
        jcfg.sensor, want_image=True)
    pt = pretreatment.pretreat(torch.from_numpy(scan.points),
                               torch.from_numpy(scan.valid), tcfg.sensor)
    img_t, ext_t = projection.project_and_extract(
        pt.points[:, :3], pt.points[:, 3], pt.ring, pt.rel_time, pt.valid,
        tcfg.sensor, want_image=True)
    return img_j, img_t, ext_t


def test_range_image_bit_equal(hdl64):
    scan, (jcfg, _), (tcfg, _) = hdl64
    img_j, img_t, ext_t = _images(scan, jcfg, tcfg)
    assert int(img_t.mask.sum()) > 10000
    for f in img_j._fields:
        a, b = np.asarray(getattr(img_j, f)), getattr(img_t, f).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(b, a, err_msg=f)
    # the image and the compacted cloud hold the same winners
    assert int(img_t.mask.sum()) == int(ext_t.count.sum())
    rows = img_t.mask.nonzero()
    np.testing.assert_array_equal(
        ext_t.xyz[ext_t.mask].numpy(), img_t.xyz[rows[:, 0], rows[:, 1]]
        .numpy())


def test_infer_labels_matches_jax(hdl64):
    scan, (jcfg, jwrap), (tcfg, twrap) = hdl64
    img_j, img_t, _ = _images(scan, jcfg, tcfg)
    sem_j = jax.jit(lambda *a: jfusion.infer_labels(
        jwrap.model, jwrap.variables, *a, jwrap.cfg.semantic))(
        img_j.rng, img_j.xyz, img_j.intensity, img_j.mask)
    sem_t = fusion.infer_labels(twrap.model, img_t.rng, img_t.xyz,
                                img_t.intensity, img_t.mask,
                                twrap.cfg.semantic)
    mask = np.asarray(img_j.mask)
    lab_j, lab_t = np.asarray(sem_j.labels), sem_t.labels.numpy()
    assert sem_t.labels.dtype == torch.int32 and lab_t.shape == mask.shape
    assert (lab_t[~mask] == 0).all()
    agree = (lab_t == lab_j)[mask].mean()
    assert agree >= LABEL_AGREE, agree
    same = (lab_t == lab_j)
    np.testing.assert_array_equal(sem_t.category.numpy()[same],
                                  np.asarray(sem_j.category)[same])
    np.testing.assert_array_equal(sem_t.weight.numpy()[same],
                                  np.asarray(sem_j.weight)[same])
    pm_t, pm_j = sem_t.probs_max.numpy(), np.asarray(sem_j.probs_max)
    assert np.abs(pm_t - pm_j)[mask].mean() < 2e-3
    assert (pm_t[mask] > 0).all() and (pm_t <= 1.0 + 1e-6).all()


def test_label_tables_match_jax():
    rng = np.random.default_rng(4)
    lab = rng.integers(0, 20, (16, 90)).astype(np.int32)
    mask = rng.uniform(size=lab.shape) > 0.3
    pm = rng.uniform(size=lab.shape).astype(np.float32)
    for p in (None, pm):
        sj = jfusion.label_images(jnp.asarray(lab), jnp.asarray(mask),
                                  None if p is None else jnp.asarray(p))
        st = fusion.label_images(torch.from_numpy(lab),
                                 torch.from_numpy(mask),
                                 None if p is None else torch.from_numpy(p))
        for f in sj._fields:
            a, b = np.asarray(getattr(sj, f)), getattr(st, f).numpy()
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(b, a, err_msg=f)
        for c in range(5):
            np.testing.assert_array_equal(
                fusion.category_mask(st, c).numpy(),
                np.asarray(jfusion.category_mask(sj, c)))
        np.testing.assert_array_equal(fusion.dynamic_mask(st).numpy(),
                                      np.asarray(jfusion.dynamic_mask(sj)))
    for lab_in in (lab, np.array([[-3, 0, 25]])):
        np.testing.assert_array_equal(fusion.labels_to_rgb(lab_in),
                                      jfusion.labels_to_rgb(lab_in))


def test_infer_scan_labels_per_point(hdl64):
    scan, (_jcfg, jwrap), (_tcfg, twrap) = hdl64
    lab_j, _ = jwrap(jnp.asarray(scan.points), jnp.asarray(scan.valid))
    lab_t, sem_t = twrap(torch.from_numpy(scan.points),
                         torch.from_numpy(scan.valid))
    lab_j, lab_t = np.asarray(lab_j), lab_t.numpy()
    assert lab_t.dtype == np.int32 and lab_t.shape == lab_j.shape
    v = scan.valid
    agree = (lab_t == lab_j)[v].mean()
    assert agree >= LABEL_AGREE, agree
    for lab in (lab_j, lab_t):
        m = v & (lab > 0)
        assert m.sum() > 10000
        acc = (lab[m] == scan.labels[m]).mean()
        assert acc > 0.8, acc
    assert sem_t.labels.shape == (64, 1800)


def test_winner_labels_from_front_end_projection(hdl64):
    """slam_step's labelling from the front end's projection: the winners
    carry exactly infer_scan_labels' labels, every other point 0."""
    scan, _j, (tcfg, twrap) = hdl64
    pts, valid = torch.from_numpy(scan.points), torch.from_numpy(scan.valid)
    pre = pretreatment.pretreat(pts, valid, tcfg.sensor)
    _img, ext = projection.project_and_extract(
        pre.points[:, :3], pre.points[:, 3], pre.ring, pre.rel_time,
        pre.valid, tcfg.sensor)
    lab_w = inference.infer_winner_labels(twrap.model, ext, pts.shape[0],
                                          twrap.cfg)
    lab_s, _sem = twrap(pts, valid)
    assert lab_w.dtype == torch.int32 and lab_w.shape == lab_s.shape
    win = torch.zeros_like(valid)
    win[ext.src[ext.mask].long()] = True
    assert int(win.sum()) > 10000 and int((lab_w[win] > 0).sum()) > 10000
    np.testing.assert_array_equal(lab_w[win].numpy(), lab_s[win].numpy())
    assert int(lab_w[~win].abs().sum()) == 0


def _infer_cfgs():
    """tiny_cfgs with semantics on (the checkpoint's architecture)."""
    jcfg, tcfg = tiny_cfgs()
    return (jcfg.replace(semantic=dataclasses.replace(jcfg.semantic,
                                                      enabled=True)),
            tcfg.replace(semantic=dataclasses.replace(tcfg.semantic,
                                                      enabled=True)))


def test_slam_step_infer_keyframe_from_carried_state():
    """Step the JAX package in "infer" mode over the first scans; at the
    first keyframe after the semantic map has content, carry its
    FusedState into the port and run that scan through both slam_steps."""
    jcfg, tcfg = _infer_cfgs()
    jw = jinf.SemanticInference(jcfg)
    tw = inference.SemanticInference(tcfg, device="cpu")
    scans, _gt = render_plaza(10, seed0=620)
    fstate = jslam.SemanticSlam(jcfg).fstate
    zeros = jnp.zeros(jcfg.sensor.max_raw_points, jnp.int32)
    compared = 0
    for s in scans:
        snap = convert.fused_state_to_numpy(fstate)
        sin = jdriver.pad_scan(s.points[s.valid], jcfg)
        fstate, out_j = jslam.slam_step(fstate, sin, zeros, jw.variables,
                                        jcfg, "infer", jw.model, jw.cfg)
        if not (bool(out_j.is_keyframe) and int(snap["sem"]["kf_count"]) >= 3):
            continue
        st = convert.fused_state_from_numpy(snap)
        st2, out_t = slam.slam_step(
            st, driver.pad_scan(s.points[s.valid], tcfg), None, tcfg,
            "infer", tw.model, tw.cfg)
        assert out_t.is_keyframe
        p, pj = out_t.pose.numpy(), np.asarray(out_j.pose)
        np.testing.assert_allclose(p[3:], pj[3:], atol=POS_ATOL)
        np.testing.assert_allclose(p[:3], pj[:3], atol=ANG_ATOL)
        np.testing.assert_allclose(out_t.refined.numpy(),
                                   np.asarray(out_j.refined),
                                   atol=REFINED_ATOL)
        sm = out_t.surf_mask.numpy()
        np.testing.assert_array_equal(sm, np.asarray(out_j.surf_mask))
        lab_t, lab_j = out_t.lab_surf.numpy(), np.asarray(out_j.lab_surf)
        assert (lab_t[sm] > 0).mean() > 0.5  # the net labelled the scan
        assert (lab_t == lab_j)[sm].mean() >= 0.99
        n_t = out_t.class_mask.numpy().sum(1)
        n_j = np.asarray(out_j.class_mask).sum(1)
        assert n_j.sum() > 1000
        np.testing.assert_allclose(n_t, n_j, rtol=0.01, atol=2)
        assert int(st2.sem.kf_count) == int(snap["sem"]["kf_count"]) + 1
        compared += 1
        break
    assert compared == 1


@pytest.mark.slow
def test_full_slam_with_inferred_labels():
    """tests/test_semantic_infer.py::test_full_slam_with_inferred_labels
    for the port: full SLAM with inferred labels stays within 1.5 x the
    gt-label ATE + 0.03 m."""
    from lis_slam_torch.semantic import weights as W

    sem_cfg, _ = W.load_checkpoint()
    cfg = SlamConfig().replace(sensor=SensorConfig(max_raw_points=64 * 1800))
    n = 14
    world = jsyn.make_world(seed=5)
    gt = jsyn.circular_trajectory(n + 1, radius=60.0, speed=8.0)
    scans = [jsyn.render_scan(world, gt[i], None, seed=50 + i)
             for i in range(n)]
    gt_rel = trajectory.relative_to_first(gt[:n])

    def run(infer: bool):
        c = cfg.replace(semantic=dataclasses.replace(
            sem_cfg, enabled=True)) if infer else cfg
        system = slam.SemanticSlam(c, device="cpu")
        assert (system.model is not None) == infer
        for s in scans:
            system.process_scan(
                driver.pad_scan(s.points[s.valid], c),
                gt_labels=None if infer else s.labels[s.valid])
        return trajectory.ate_rmse(system.finish().poses, gt_rel,
                                   align=False)

    ate_gt = run(False)
    ate_inf = run(True)
    assert ate_inf < 1.5 * ate_gt + 0.03, (ate_inf, ate_gt)
