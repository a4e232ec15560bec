"""Port parity of NDT and the registration-method factory
(lis_slam_torch/ops/icp.py against lis_slam_tpu/ops/icp.py:159-254) on a
16-beam render of the plaza (tests/_torch_plaza.py).

- build_ndt: bit-equal to the JAX function run op by op
  (jax.disable_jit); against its jitted form the voxel mask equal, means
  within 1e-4 m, and the regularized covariances within 4e-6 x the
  largest squared mean (the moments E[x x^T] - mu mu^T cancel in float32,
  and XLA's fusion rounds them in another order: the jitted inverse
  covariances differ from the op-by-op ones by up to ~5% of their largest
  entry).
- ndt_align from the origin on the op-by-op grid: the transform within
  1e-4, the same iterations, convergence and inlier count; the error
  left in translation and in rotation at most a quarter of the offset
  (one 1 m voxel Gaussian per point on a 16-beam scan leaves ~3 cm and
  ~8 mrad of roll here, in both packages).
- select_registration_method: the names, and ValueError on any other.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax
import jax.numpy as jnp
import torch

from lis_slam_tpu.ops import icp as jicp
from lis_slam_torch.ops import icp
from lis_slam_torch.utils import se3_np

from _torch_plaza import render_plaza

TRUE = np.array([0.01, -0.008, 0.04, 0.35, -0.2, 0.03])  # target <- source


@pytest.fixture(scope="module")
def clouds():
    (s0,), _gt = render_plaza(1)
    tgt = s0.points[:, :3].astype(np.float32)
    tmask = s0.valid.copy()
    # the source: every other point of the scan moved into a frame offset
    # by TRUE^-1, so aligning it onto the target recovers TRUE
    src = s0.points[1::2, :3].astype(np.float64)
    Ti = np.linalg.inv(se3_np.pose_to_matrix(TRUE))
    src = (src @ Ti[:3, :3].T + Ti[:3, 3]).astype(np.float32)
    return tgt, tmask, src, s0.valid[1::2].copy()


def _grids(tgt, tmask):
    """(JAX grid op by op, the port's grid)."""
    with jax.disable_jit():
        jg = jicp.build_ndt(jnp.asarray(tgt), jnp.asarray(tmask),
                            resolution=1.0, capacity=8192)
    tg = icp.build_ndt(torch.from_numpy(tgt), torch.from_numpy(tmask),
                       resolution=1.0, capacity=8192)
    return jg, tg


def test_build_ndt_matches_jax(clouds):
    tgt, tmask, _src, _sm = clouds
    jg, tg = _grids(tgt, tmask)
    m = np.asarray(jg.mask)
    assert m.sum() > 200
    for f in ("mean", "info", "mask"):
        np.testing.assert_array_equal(getattr(tg, f).numpy(),
                                      np.asarray(getattr(jg, f)), err_msg=f)
    for f in ("points", "point_id", "bucket_start"):
        np.testing.assert_array_equal(getattr(tg.hash, f).numpy(),
                                      np.asarray(getattr(jg.hash, f)))
    jit = jicp.build_ndt(jnp.asarray(tgt), jnp.asarray(tmask),
                         resolution=1.0, capacity=8192)
    np.testing.assert_array_equal(tg.mask.numpy(), np.asarray(jit.mask))
    mean = tg.mean.numpy()[m]
    np.testing.assert_allclose(mean, np.asarray(jit.mean)[m], atol=1e-4)
    cov = np.linalg.inv(tg.info.numpy()[m].astype(np.float64))
    jcov = np.linalg.inv(np.asarray(jit.info)[m].astype(np.float64))
    assert np.abs(cov - jcov).max() <= 4e-6 * (mean ** 2).max()


@pytest.mark.parametrize("max_iterations", [30, 3])
def test_ndt_align_matches_jax(clouds, max_iterations):
    tgt, tmask, src, smask = clouds
    jg, tg = _grids(tgt, tmask)
    jr = jicp.ndt_align(jnp.asarray(src), jnp.asarray(smask), jg,
                        jnp.eye(4), max_iterations=max_iterations)
    tr = icp.ndt_align(torch.from_numpy(src), torch.from_numpy(smask), tg,
                       torch.eye(4), max_iterations=max_iterations)
    assert tr.iterations == int(jr.iterations)
    assert tr.converged == bool(jr.converged)
    assert tr.n_inliers == int(jr.n_inliers)
    np.testing.assert_allclose(tr.transform.numpy(),
                               np.asarray(jr.transform), atol=1e-4)
    np.testing.assert_allclose(tr.fitness, float(jr.fitness), rtol=1e-3)
    if max_iterations == 30:
        assert tr.converged
        got = se3_np.matrix_to_pose(tr.transform.numpy().astype(np.float64))
        for sl in (slice(3, 6), slice(0, 3)):
            assert (np.linalg.norm(got[sl] - TRUE[sl])
                    <= 0.25 * np.linalg.norm(TRUE[sl]))


def test_select_registration_method(clouds):
    assert icp.select_registration_method("ndt") is icp.ndt_align
    for name, plane in (("icp", False), ("gicp", True), ("icp_plane", True)):
        f = icp.select_registration_method(name)
        assert f.func is icp.icp and f.keywords == {"point_to_plane": plane}
        jf = jicp.select_registration_method(name)
        assert jf.keywords == f.keywords
    for bad in ("NDT", "gicp_omp", ""):
        with pytest.raises(ValueError, match="unknown registration method"):
            icp.select_registration_method(bad)
        with pytest.raises(ValueError):
            jicp.select_registration_method(bad)
