"""Port parity of the voxel-hash k-NN (ops/knn.py VoxelHashMap, build_hash,
knn_hash) against lis_slam_tpu/ops/knn.py on seeded clouds: the sorted
store, bucket offsets, distances and indices all bit-equal. The clouds
span negative cells, so the hash's uint32 wrap of negative coordinates
(done in int64 with a 32-bit mask in the port) is exercised."""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp
import torch

from lis_slam_tpu.ops import knn as jknn
from lis_slam_torch.ops import knn as tknn


def _cloud(seed, n, spread=20.0, mask_frac=0.85):
    r = np.random.default_rng(seed)
    pts = r.uniform(-spread, spread, (n, 3)).astype(np.float32)
    mask = r.uniform(size=n) < mask_frac
    return pts, mask


@pytest.mark.parametrize("cell,table", [(1.0, 1 << 12), (0.5, 1 << 10),
                                        (2.0, 1 << 15)])
def test_build_hash_bit_equal(cell, table):
    pts, mask = _cloud(0, 5000)
    hj = jknn.build_hash(jnp.asarray(pts), jnp.asarray(mask), cell_size=cell,
                         table_size=table)
    ht = tknn.build_hash(torch.from_numpy(pts), torch.from_numpy(mask),
                         cell_size=cell, table_size=table)
    assert ht.table_size == hj.table_size
    np.testing.assert_array_equal(ht.point_id.numpy(), np.asarray(hj.point_id))
    np.testing.assert_array_equal(ht.points.numpy(), np.asarray(hj.points))
    np.testing.assert_array_equal(ht.bucket_start.numpy(),
                                  np.asarray(hj.bucket_start))


def test_hash_cells_wraps_negative_cells():
    c = np.array([-1, -7, 0, 2**31 - 1, -(2**31), 123456], np.int32)
    hj = jknn._hash_cells(jnp.asarray(c), jnp.asarray(c[::-1]),
                          jnp.asarray(-c), 1 << 16)
    ht = tknn._hash_cells(torch.from_numpy(c), torch.from_numpy(c[::-1].copy()),
                          torch.from_numpy(-c), 1 << 16)
    np.testing.assert_array_equal(ht.numpy(), np.asarray(hj))


@pytest.mark.parametrize("k", [1, 5])
@pytest.mark.parametrize("bucket_cap", [4, 16])
def test_knn_hash_bit_equal(k, bucket_cap):
    """Dense enough that buckets overflow at cap 4: the probe order (and
    the lowest-slot tie rule) decides which neighbors are seen."""
    pts, mask = _cloud(1, 6000, spread=8.0)
    r = np.random.default_rng(2)
    q = (pts[r.integers(0, len(pts), 700)]
         + r.normal(0, 0.3, (700, 3))).astype(np.float32)
    q = np.concatenate([q, r.uniform(-30, 30, (100, 3)).astype(np.float32)])
    hj = jknn.build_hash(jnp.asarray(pts), jnp.asarray(mask), cell_size=1.0,
                         table_size=1 << 12)
    ht = tknn.build_hash(torch.from_numpy(pts), torch.from_numpy(mask),
                         cell_size=1.0, table_size=1 << 12)
    dj, ij = jknn.knn_hash(jnp.asarray(q), hj, k=k, bucket_cap=bucket_cap)
    dt, it = tknn.knn_hash(torch.from_numpy(q), ht, k=k,
                           bucket_cap=bucket_cap)
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    # the queries near the cloud find a neighbor within the cell
    assert (dt.numpy()[:700, 0] < 1.0).mean() > 0.9
