"""Port parity of the stage-1 semantic refinement
(pipeline/semantic_odometry.py) against lis_slam_tpu/pipeline/
semantic_odometry.py, on 16 x 900 scans of the plaza world along the
bench's 10 m lap, with ground-truth labels (tests/_torch_plaza.py).

- semantic_scan_from_ext: every SemanticScan field equal, from the front
  end's own extracted cloud (the port's projection is bit-equal to the
  JAX one, tests/test_torch_ops.py).
- refine_step: the JAX package builds the semantic local map over the
  first scans (guesses perturbed from ground truth); the port takes the
  map over (pipeline/convert.py) and both refine the next scan: pose
  within 2e-3 m / 2e-4 rad, and the updated map's masks and dynamic flags
  equal. Once more with a degeneracy threshold that forces the ICP
  fallback (the solve is then flagged degenerate every iteration).
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp
import torch

from lis_slam_tpu.pipeline import driver as jdriver, odometry as jodo
from lis_slam_tpu.pipeline import semantic_odometry as jsemo
from lis_slam_torch.ops import icp as ticp
from lis_slam_torch.pipeline import convert, driver, odometry
from lis_slam_torch.pipeline import semantic_odometry as tsemo

from _torch_plaza import render_plaza, tiny_cfgs

POS_ATOL = 2e-3  # m
ANG_ATOL = 2e-4  # rad
N_MAP = 4  # scans the JAX package maps before the compared step


def _labels(s, cfg):
    buf = np.zeros(cfg.sensor.max_raw_points, np.int32)
    lab = s.labels[s.valid]
    buf[:len(lab)] = lab
    return buf


@pytest.fixture(scope="module")
def jax_map():
    jcfg, _ = tiny_cfgs()
    scans, gt = render_plaza(N_MAP + 1)
    gt_rel = np.asarray(gt[:N_MAP + 1] - gt[0], np.float32)
    r = np.random.default_rng(0)
    state = jsemo.init_state(jcfg)
    for i in range(N_MAP):
        s = scans[i]
        _fc, ext = jodo.preprocess(jdriver.pad_scan(s.points[s.valid], jcfg),
                                   jcfg, return_ext=True)
        sscan = jsemo.semantic_scan_from_ext(
            ext, jnp.asarray(_labels(s, jcfg)), jcfg)
        guess = gt_rel[i] + r.normal(0, [0.002] * 3 + [0.03] * 3).astype(
            np.float32) * (i > 0)
        state, _pose, _gn = jsemo.refine_step(state, sscan,
                                              jnp.asarray(guess), jcfg)
    guess = gt_rel[N_MAP] + np.array([0.003, -0.002, 0.01, 0.08, -0.05,
                                      0.02], np.float32)
    return scans, state, guess


def test_semantic_scan_from_ext_equal(jax_map):
    scans, _state, _guess = jax_map
    jcfg, tcfg = tiny_cfgs()
    s = scans[N_MAP]
    _fc, ext_j = jodo.preprocess(jdriver.pad_scan(s.points[s.valid], jcfg),
                                 jcfg, return_ext=True)
    _fc, ext_t = odometry.preprocess(driver.pad_scan(s.points[s.valid], tcfg),
                                     tcfg, return_ext=True)
    lab = _labels(s, jcfg)
    sj = jsemo.semantic_scan_from_ext(ext_j, jnp.asarray(lab), jcfg)
    st = tsemo.semantic_scan_from_ext(ext_t, torch.from_numpy(lab), tcfg)
    for f in jsemo.SemanticScan._fields:
        np.testing.assert_array_equal(getattr(st, f).numpy(),
                                      np.asarray(getattr(sj, f)), err_msg=f)
    assert int(st.class_mask.sum()) > 1000 and int(st.corner_mask.sum()) > 10


@pytest.mark.parametrize("force_fallback", [False, True])
def test_refine_step_from_carried_state(jax_map, monkeypatch,
                                        force_fallback):
    scans, state_j, guess = jax_map
    extra = dict(degeneracy_eigen_threshold=1e12) if force_fallback else {}
    jcfg, tcfg = tiny_cfgs(**extra)
    s = scans[N_MAP]
    lab = _labels(s, jcfg)
    _fc, ext_j = jodo.preprocess(jdriver.pad_scan(s.points[s.valid], jcfg),
                                 jcfg, return_ext=True)
    sscan_j = jsemo.semantic_scan_from_ext(ext_j, jnp.asarray(lab), jcfg)
    new_j, pose_j, gn_j = jsemo.refine_step(state_j, sscan_j,
                                            jnp.asarray(guess), jcfg)
    assert bool(gn_j.degenerate) == force_fallback

    calls = []
    real_icp = ticp.icp
    monkeypatch.setattr(ticp, "icp", lambda *a, **k: calls.append(1)
                        or real_icp(*a, **k))
    state_t = convert.sem_state_from_numpy(convert.sem_state_to_numpy(
        state_j))
    _fc, ext_t = odometry.preprocess(driver.pad_scan(s.points[s.valid], tcfg),
                                     tcfg, return_ext=True)
    sscan_t = tsemo.semantic_scan_from_ext(ext_t, torch.from_numpy(lab), tcfg)
    new_t, pose_t, gn_t = tsemo.refine_step(state_t, sscan_t,
                                            torch.from_numpy(guess), tcfg)
    assert gn_t.degenerate == force_fallback
    assert len(calls) == (1 if force_fallback or not gn_t.converged else 0)
    p, pj = pose_t.numpy(), np.asarray(pose_j)
    np.testing.assert_allclose(p[3:], pj[3:], atol=POS_ATOL)
    np.testing.assert_allclose(p[:3], pj[:3], atol=ANG_ATOL)
    # the refinement moved the pose off the perturbed guess
    assert np.linalg.norm(p[3:] - guess[3:]) > 0.02
    assert int(new_t.kf_count) == int(new_j.kf_count) == N_MAP + 1
    for f in ("corner_mask", "surf_mask", "surf_dyn"):
        a, b = getattr(new_t, f).numpy(), np.asarray(getattr(new_j, f))
        assert abs(int(a.sum()) - int(b.sum())) <= 0.002 * b.sum() + 2, f
    np.testing.assert_array_equal(new_t.surf_w.numpy(),
                                  np.asarray(new_j.surf_w))


def test_sem_state_round_trip(jax_map):
    _scans, state_j, _guess = jax_map
    arrays = convert.sem_state_to_numpy(state_j)
    back = convert.sem_state_to_numpy(convert.sem_state_from_numpy(arrays))
    for f, a in arrays.items():
        assert back[f].dtype == a.dtype, f
        np.testing.assert_array_equal(back[f], a, err_msg=f)


def test_build_semantic_scan_equal(jax_map):
    """build_semantic_scan from a raw padded scan: every field equal to
    the JAX package's (tests/test_semantic_odometry.py:46's call)."""
    scans, _state, _guess = jax_map
    jcfg, tcfg = tiny_cfgs()
    s = scans[N_MAP - 1]
    lab = _labels(s, jcfg)
    sj = jsemo.build_semantic_scan(jdriver.pad_scan(s.points[s.valid], jcfg),
                                   jnp.asarray(lab), jcfg)
    st = tsemo.build_semantic_scan(driver.pad_scan(s.points[s.valid], tcfg),
                                   torch.from_numpy(lab), tcfg)
    for f in jsemo.SemanticScan._fields:
        np.testing.assert_array_equal(getattr(st, f).numpy(),
                                      np.asarray(getattr(sj, f)), err_msg=f)
    assert int(st.corner_mask.sum()) > 10 and int(st.surf_mask.sum()) > 1000
