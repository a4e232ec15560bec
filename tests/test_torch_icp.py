"""Port parity of the GN ICP (ops/icp.py `icp`, `fitness_score`) against
lis_slam_tpu/ops/icp.py: a structured target (ground, two walls, a few
poles), the source a perturbed subset seen from a displaced pose. Same
iteration count and exit flag; transform within 1e-4; fitness within
1e-5 relative. Covers point-to-point and point-to-plane, per-iteration
search and the verify schedule, and a schedule without 0 (the JAX
package's zeroed neighbor cache, matched on purpose). Point-to-point ICP
on this scene never meets its step test: it runs to the cap, and float32
rounding (the 1500-row J^T J sums in another order) parts the two
iterate sequences by 2e-5 at 20 iterations and 5e-4 at 30, so that case
is held at a 15-iteration cap; the pipeline runs point-to-plane only."""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp
import torch

from lis_slam_tpu.ops import icp as jicp, knn as jknn
from lis_slam_tpu.utils import se3 as jse3
from lis_slam_torch.ops import icp as ticp, knn as tknn

T_ATOL = 1e-4


def _scene(seed=0, n=6000):
    r = np.random.default_rng(seed)
    k = n // 4
    ground = np.stack([r.uniform(-15, 15, k), r.uniform(-15, 15, k),
                       r.normal(0, 0.01, k)], 1)
    wall1 = np.stack([r.uniform(-15, 15, k), np.full(k, 8.0)
                      + r.normal(0, 0.01, k), r.uniform(0, 5, k)], 1)
    wall2 = np.stack([np.full(k, -9.0) + r.normal(0, 0.01, k),
                      r.uniform(-15, 15, k), r.uniform(0, 5, k)], 1)
    poles = np.concatenate([np.stack([np.full(k // 4, x) + r.normal(
        0, 0.05, k // 4), np.full(k // 4, y) + r.normal(0, 0.05, k // 4),
        r.uniform(0, 4, k // 4)], 1) for x, y in ((3, 2), (-4, 5), (6, -6),
                                                   (-2, -7))])
    tgt = np.concatenate([ground, wall1, wall2, poles]).astype(np.float32)
    tmask = r.uniform(size=len(tgt)) > 0.05
    src_w = tgt[r.integers(0, len(tgt), 1500)] + r.normal(0, 0.02, (1500, 3))
    pose = np.array([0.01, -0.015, 0.06, 0.4, -0.3, 0.05], np.float32)
    T = np.asarray(jse3.pose_to_matrix(jnp.asarray(pose)))
    src = ((src_w - T[:3, 3]) @ T[:3, :3]).astype(np.float32)
    smask = r.uniform(size=len(src)) > 0.05
    return src, smask, tgt, tmask


@pytest.mark.parametrize("plane,refresh,iters", [
    (True, (), 30), (True, (0, 4, 10, 18), 30), (False, (), 15),
    (True, (2, 5), 30)])
def test_icp_matches_jax(plane, refresh, iters):
    src, smask, tgt, tmask = _scene()
    hj = jknn.build_hash(jnp.asarray(tgt), jnp.asarray(tmask), cell_size=1.0,
                         table_size=1 << 14)
    ht = tknn.build_hash(torch.from_numpy(tgt), torch.from_numpy(tmask),
                         cell_size=1.0, table_size=1 << 14)
    init = np.eye(4, dtype=np.float32)
    kw = dict(max_correspond_dist=2.0, max_iterations=iters,
              point_to_plane=plane, refresh_iters=refresh)
    rj = jicp.icp(jnp.asarray(src), jnp.asarray(smask), jnp.asarray(tgt), hj,
                  jnp.asarray(init), **kw)
    rt = ticp.icp(torch.from_numpy(src), torch.from_numpy(smask),
                  torch.from_numpy(tgt), ht, torch.from_numpy(init), **kw)
    assert rt.iterations == int(rj.iterations)
    assert rt.converged == bool(rj.converged)
    assert rt.n_inliers == int(rj.n_inliers)
    np.testing.assert_allclose(rt.transform.numpy(), np.asarray(rj.transform),
                               atol=T_ATOL)
    assert rt.fitness == pytest.approx(float(rj.fitness), rel=1e-5,
                                       abs=1e-9)
    if refresh != (2, 5):  # the zeroed cache does not converge to truth
        assert abs(float(rt.transform[0, 3]) - 0.4) < 0.05


def test_fitness_score_matches_jax():
    src, smask, tgt, tmask = _scene(1)
    T = np.eye(4, dtype=np.float32)
    T[:3, 3] = [0.3, -0.2, 0.0]
    hj = jknn.build_hash(jnp.asarray(tgt), jnp.asarray(tmask))
    ht = tknn.build_hash(torch.from_numpy(tgt), torch.from_numpy(tmask))
    fj = jicp.fitness_score(jnp.asarray(src), jnp.asarray(smask), hj,
                            jnp.asarray(T))
    ft = ticp.fitness_score(torch.from_numpy(src), torch.from_numpy(smask),
                            ht, torch.from_numpy(T))
    assert float(ft) == pytest.approx(float(fj), rel=1e-5)
