"""Port parity of the centroid voxel downsample and the two random
downsample masks of the submap manager.

The centroid `voxel_downsample` is held to JAX's `centroid=True` on the
same seeded points (tests/test_knn_voxel.py's case and a capacity
overflow): counts and masks equal, centroids within CENTROID_RTOL of each
coordinate's magnitude (JAX sums each voxel in float32 in input order;
the port sums in float64 and rounds once). The masks draw from a
torch.Generator where JAX takes a PRNG key, so they are held to their
invariants and their distribution, not to JAX's bits.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp
import torch

from lis_slam_tpu.ops import voxel as jvox
from lis_slam_torch.mapping import submap as tsub
from lis_slam_torch.ops import voxel as tvox

# float32 sum of a voxel's n points in input order vs one float64 sum:
# <= ~n/2 ulps of the coordinate; 2e-6 of it bounds n up to ~30 points
CENTROID_RTOL = 2e-6


def _cases():
    r = np.random.default_rng(3)
    pts = r.uniform(-5, 5, (3000, 3)).astype(np.float32)
    mask = np.ones(3000, bool)
    mask[2500:] = False
    yield "golden", pts, mask, 0.5, 4096
    # dense voxels (~28 points each) and more voxels than capacity
    r = np.random.default_rng(4)
    pts = r.uniform(-30, 30, (6000, 3)).astype(np.float32)
    # at the min corner, so its voxels sort first and fill the capacity
    pts[:2000] = (r.uniform(-2, 2, (2000, 3)) - 40.0).astype(np.float32)
    mask = r.random(6000) < 0.9
    yield "overflow", pts, mask, 1.0, 512


@pytest.mark.parametrize("case", list(_cases()), ids=lambda c: c[0])
def test_centroid_matches_jax(case):
    _name, pts, mask, leaf, cap = case
    jo, jm, jn = jvox.voxel_downsample(jnp.asarray(pts), jnp.asarray(mask),
                                       leaf=leaf, capacity=cap, centroid=True)
    to, tm, tn = tvox.voxel_downsample(torch.from_numpy(pts),
                                       torch.from_numpy(mask), leaf, cap,
                                       centroid=True)
    assert int(tn) == int(jn)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    jo = np.asarray(jo)
    to = to.numpy()
    np.testing.assert_array_equal(to[~tm.numpy()], 0.0)
    err = np.abs(to - jo) / np.maximum(np.abs(jo), 1.0)
    assert err.max() <= CENTROID_RTOL, err.max()
    if _name == "overflow":
        assert int(jn) == cap  # the case does overflow


def test_centroid_refuses_payloads():
    pts = torch.zeros(8, 3)
    with pytest.raises(ValueError):
        tvox.voxel_downsample(pts, torch.ones(8, dtype=torch.bool), 0.5, 8,
                              payloads=(torch.zeros(8),), centroid=True)


def test_centroid_lanes_equal_one_lane_calls():
    r = np.random.default_rng(5)
    pts = torch.from_numpy(r.uniform(-10, 10, (3, 2000, 3)).astype(np.float32))
    mask = torch.from_numpy(r.random((3, 2000)) < 0.8)
    mask[2] = False  # an empty lane
    lo, lm, ln = tvox.voxel_downsample(pts, mask, 0.7, 1024, centroid=True)
    assert ln.shape == (3,) and int(ln[2]) == 0
    for b in range(3):
        o, m, n = tvox.voxel_downsample(pts[b], mask[b], 0.7, 1024,
                                        centroid=True)
        assert torch.equal(lo[b], o) and torch.equal(lm[b], m)
        assert int(ln[b]) == int(n)


def _gen(seed):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


def _mask(n=100_000, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).random(n) < 0.7)


def _within_5_sigma(kept, n, p):
    sigma = np.sqrt(n * p * (1 - p))
    assert abs(kept - n * p) <= 5 * sigma, (kept, n * p, sigma)


@pytest.mark.parametrize("ratio", [0.1, 0.5, 0.93])
def test_random_mask_distribution(ratio):
    mask = _mask()
    out = tsub.random_downsample_mask(mask, ratio, _gen(1))
    assert not bool((out & ~mask).any())  # a subset of the input
    _within_5_sigma(int(out.sum()), int(mask.sum()), ratio)
    again = tsub.random_downsample_mask(mask, ratio, _gen(1))
    assert torch.equal(out, again)  # the same seed, the same mask


def test_random_mask_edges():
    mask = _mask(1000)
    assert not bool(tsub.random_downsample_mask(mask, 0.0, _gen(2)).any())
    assert torch.equal(tsub.random_downsample_mask(mask, 1.0, _gen(2)), mask)


@pytest.mark.parametrize("target", [500, 20_000, 65_000])
def test_fixed_count_mask_distribution(target):
    mask = _mask()
    n = int(mask.sum())
    out = tsub.fixed_count_downsample_mask(mask, target, _gen(3))
    assert not bool((out & ~mask).any())
    _within_5_sigma(int(out.sum()), n, min(1.0, target / n))
    again = tsub.fixed_count_downsample_mask(mask, target, _gen(3))
    assert torch.equal(out, again)


def test_fixed_count_mask_edges():
    mask = _mask(1000)
    n = int(mask.sum())
    for target in (n, n + 1, 10 * n):  # target >= n keeps every point
        assert torch.equal(
            tsub.fixed_count_downsample_mask(mask, target, _gen(4)), mask)
    assert not bool(
        tsub.fixed_count_downsample_mask(mask, 0, _gen(4)).any())
    empty = torch.zeros(1000, dtype=torch.bool)  # n = 0: max(n, 1)
    assert not bool(
        tsub.fixed_count_downsample_mask(empty, 10, _gen(4)).any())
