"""Port parity: the plain version of kernel K1 (lis_slam_torch/ops/knn_cuda.py
knn_plain, over ops/knn.py knn_bruteforce) against the JAX package's Pallas
kNN in interpret mode and against scipy's cKDTree.

Tolerances as tests/test_pallas_knn.py (rtol 1e-3 / atol 1e-4 on squared
distances): the Pallas kernel forms |q|^2 + |r|^2 - 2 q.r on the matrix
unit and only then recomputes the winners' exact distances, so a
near-tie can pick another point; the port computes (q - r)^2 exactly.
"""

import numpy as np
import pytest
from scipy.spatial import cKDTree

pytest.importorskip("jax")

import jax.numpy as jnp
import torch

from lis_slam_tpu.ops import pallas_knn
from lis_slam_torch.ops import knn as tknn, knn_cuda

RTOL, ATOL = 1e-3, 1e-4


@pytest.fixture(scope="module")
def clouds():
    r = np.random.default_rng(11)
    ref = r.uniform(-30, 30, (4096, 3)).astype(np.float32)
    q = r.uniform(-30, 30, (512, 3)).astype(np.float32)
    mask = r.uniform(size=4096) > 0.3  # holes all through the map
    return q, ref, mask


def _port(q, ref, mask, k, cap):
    d, i, xyz = knn_cuda.knn(torch.from_numpy(q), torch.from_numpy(ref),
                             torch.from_numpy(mask), k=k, max_sq_dist=cap)
    return d.numpy(), i.numpy(), xyz.numpy()


@pytest.mark.parametrize("k", [1, 8])
@pytest.mark.parametrize("cap", [None, 4.0])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("n_q,n_ref", [(512, 4096), (300, 3000)])
def test_knn_plain_matches_pallas_and_kdtree(clouds, k, cap, masked, n_q,
                                             n_ref):
    """k in {1, 8}, with and without the cap, masked map, and sizes that are
    not multiples of the Pallas blocks (padded there)."""
    q, ref, mask = clouds
    q, ref = q[:n_q], ref[:n_ref]
    mask = mask[:n_ref] if masked else np.ones(n_ref, bool)
    d, i, xyz = _port(q, ref, mask, k, cap)
    dj, ij, xyzj = pallas_knn.knn_pallas(
        jnp.asarray(q), jnp.asarray(ref), jnp.asarray(mask), k=k,
        query_block=128, tile_n=512, interpret=True, max_sq_dist=cap)
    dj, ij = np.asarray(dj), np.asarray(ij)
    assert d.shape == (n_q, k) and i.dtype == np.int32
    # the same slots are filled (cap); unfilled ones carry index -1 and
    # d=+inf in the port, the 3e38 sentinel in the JAX package
    np.testing.assert_array_equal(i >= 0, ij >= 0)
    np.testing.assert_array_equal(np.isinf(d), i < 0)
    np.testing.assert_array_equal(dj >= 1e38, ij < 0)
    fin = i >= 0
    np.testing.assert_allclose(d[fin], dj[fin], rtol=RTOL, atol=ATOL)
    assert (i == ij).mean() > 0.99  # near-ties may reorder
    # neighbor coordinates are the indexed map points, zero when unfilled
    np.testing.assert_array_equal(
        xyz, np.where((i >= 0)[..., None], ref[np.maximum(i, 0)], 0.0))
    np.testing.assert_allclose(np.asarray(xyzj)[ij >= 0],
                               ref[ij[ij >= 0]], atol=1e-5)
    # exactness against a KD-tree over the valid points
    tree = cKDTree(ref[mask])
    dref, _ = tree.query(q, k=k)
    dref = np.square(dref).reshape(n_q, k)
    if cap is not None:
        dref = np.where(dref < cap, dref, np.inf)
    fin = np.isfinite(dref)
    np.testing.assert_array_equal(i >= 0, fin)
    np.testing.assert_allclose(d[fin], dref[fin], rtol=RTOL, atol=ATOL)
    assert mask[i[i >= 0]].all()


def test_knn_lowest_index_wins_ties():
    """Duplicated map points: the lower index comes first, as the TPU
    kernel's strict insertion and its wrapper's stable argsort give."""
    ref = np.array([[1, 0, 0], [0, 0, 0], [1, 0, 0], [0, 0, 0], [5, 5, 5]],
                   np.float32)
    q = np.zeros((2, 3), np.float32)
    d, i, _ = _port(q, ref, np.ones(5, bool), 4, None)
    np.testing.assert_array_equal(i, [[1, 3, 0, 2]] * 2)
    np.testing.assert_array_equal(d, [[0, 0, 1, 1]] * 2)


def test_knn_bruteforce_chunking_is_invisible(clouds):
    """The running merge over reference chunks gives the one-shot answer."""
    q, ref, mask = clouds
    args = (torch.from_numpy(q), torch.from_numpy(ref),
            torch.from_numpy(mask))
    d1, i1 = tknn.knn_bruteforce(*args, k=8, chunk=100)
    d2, i2 = tknn.knn_bruteforce(*args, k=8, chunk=8192)
    assert torch.equal(d1, d2) and torch.equal(i1, i2)


def test_knn_wrapper_checks_inputs(clouds):
    q, ref, mask = (torch.from_numpy(a) for a in clouds)
    with pytest.raises(TypeError):
        knn_cuda.knn(q.double(), ref, mask)
    with pytest.raises(TypeError):
        knn_cuda.knn(q, ref, mask.float())
    with pytest.raises(ValueError):
        knn_cuda.knn(q[:, :2], ref, mask)
    with pytest.raises(ValueError):
        knn_cuda.knn(q, ref, mask[:10])
    with pytest.raises(ValueError):
        knn_cuda.knn(q.to("meta"), ref.to("meta"), mask.to("meta"))


@pytest.mark.parametrize("tile", [64, 256])
def test_tile_aabb_plain_matches_numpy(tile):
    """The plain version of K1's prepass: per-tile boxes of the masked-in
    points; an all-masked tile and the ragged last tile's padding give
    lo = +inf, hi = -inf (so the skip test's bound is +inf)."""
    r = np.random.default_rng(21)
    n = 5 * tile + 37  # a ragged last tile
    ref = r.uniform(-50, 50, (n, 3)).astype(np.float32)
    mask = r.uniform(size=n) > 0.4
    mask[tile:2 * tile] = False  # an all-masked tile
    mask[3 * tile:4 * tile] = False
    mask[3 * tile + 5] = True  # a tile with one point
    lo, hi = knn_cuda.tile_aabb_plain(torch.from_numpy(ref),
                                      torch.from_numpy(mask), tile)
    assert lo.shape == hi.shape == (6, 3)
    for t in range(6):
        sel = ref[t * tile:(t + 1) * tile][mask[t * tile:(t + 1) * tile]]
        if len(sel) == 0:
            assert np.all(np.isposinf(lo[t].numpy()))
            assert np.all(np.isneginf(hi[t].numpy()))
        else:
            np.testing.assert_array_equal(lo[t].numpy(), sel.min(0))
            np.testing.assert_array_equal(hi[t].numpy(), sel.max(0))
    np.testing.assert_array_equal(lo[3].numpy(), ref[3 * tile + 5])
    empty = knn_cuda.tile_lower_bound(torch.zeros(3), torch.ones(3), lo[1],
                                      hi[1])
    assert torch.isinf(empty)


@pytest.mark.parametrize("case", ["random", "faces"])
def test_tile_lower_bound_never_exceeds_sq_dist(case):
    """K1's skip test is exact: its float32 bound, formed in the kernel's
    order, is <= the float32 squared distance (ops/knn.py sq_dist, the
    kernel's arithmetic) of every pair of a query in the query box and a
    map point in the tile box, including points on the boxes' faces and
    corners; so a tile with bound >= the k-th best changes nothing."""
    r = np.random.default_rng(22 if case == "random" else 23)
    for _ in range(40):
        c_q, c_t = r.uniform(-100, 100, (2, 3))
        q_lo = (c_q - r.uniform(0, 5, 3)).astype(np.float32)
        q_hi = (c_q + r.uniform(0, 5, 3)).astype(np.float32)
        t_lo = (c_t - r.uniform(0, 5, 3)).astype(np.float32)
        t_hi = (c_t + r.uniform(0, 5, 3)).astype(np.float32)
        q = r.uniform(q_lo, q_hi, (64, 3)).astype(np.float32)
        p = r.uniform(t_lo, t_hi, (256, 3)).astype(np.float32)
        if case == "faces":  # snap coordinates onto the boxes' faces
            qs = r.integers(0, 3, q.shape)
            q = np.where(qs == 0, q_lo, np.where(qs == 1, q_hi, q))
            ps = r.integers(0, 3, p.shape)
            p = np.where(ps == 0, t_lo, np.where(ps == 1, t_hi, p))
            q, p = q.astype(np.float32), p.astype(np.float32)
            # the boxes' corners and a box touching the query box
            q[:2], p[:2] = (q_lo, q_hi), (t_lo, t_hi)
        # the kernel's boxes are those of the points it holds
        q_t, p_t = torch.from_numpy(q), torch.from_numpy(p)
        lb = knn_cuda.tile_lower_bound(q_t.amin(0), q_t.amax(0), p_t.amin(0),
                                       p_t.amax(0))
        d = tknn.sq_dist(q_t, p_t)
        assert lb.dtype == torch.float32 and bool(torch.all(lb <= d.min()))
    # touching boxes: the bound is 0 and never above a distance
    q_t = torch.tensor([[0.0, 0.0, 0.0], [1.0, 1.0, 1.0]])
    p_t = torch.tensor([[1.0, 1.0, 1.0], [2.0, 0.5, 1.0]])
    lb = knn_cuda.tile_lower_bound(q_t.amin(0), q_t.amax(0), p_t.amin(0),
                                   p_t.amax(0))
    assert float(lb) == 0.0
