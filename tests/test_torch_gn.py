"""Port parity: the plain version of kernel K2 (lis_slam_torch/ops/gn_cuda.py
gn_partials_plain) against the JAX package's Pallas GN kernel in interpret
mode, and the port's scan_to_map against the JAX solver under both GN
backends.

Tolerances as tests/test_pallas_gn.py: H and g agree to atol 2e-4 after
scaling by max|H| and max|g| (float32 sums in another order), the solved
pose to atol 2e-3.
"""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp
import torch

from lis_slam_tpu.config import SlamConfig as JSlamConfig
from lis_slam_tpu.ops import pallas_gn, scan_match as jsm
from lis_slam_tpu.utils import se3 as jse3
from lis_slam_torch.config import SlamConfig
from lis_slam_torch.ops import gn_cuda, scan_match as tsm
from tests.test_pallas_gn import _case, _line_world, _plane_world

GN_ATOL = 2e-4
POSE_ATOL = 2e-3


def _t(x, dtype=None):
    t = torch.from_numpy(np.array(x))
    return t if dtype is None else t.to(dtype)


@pytest.mark.parametrize("mode", ["corner", "surf"])
def test_pack_scalars_match(mode):
    pose = np.array([0.02, -0.01, 0.05, 0.3, -0.2, 0.04], np.float32)
    j = pallas_gn.pack_scalars(jnp.asarray(pose), JSlamConfig().matching,
                               mode)
    t = gn_cuda.pack_scalars(_t(pose), SlamConfig().matching, mode)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-6)


@pytest.mark.parametrize("mode", ["corner", "surf"])
def test_gn_plain_matches_pallas_interpret(mode):
    cfg, pose, pts, mask, cand, ok, w, k = _case(mode, seed=3)
    H_j, g_j, nv_j = pallas_gn.gn_partials(
        pts, mask, cand, ok, w, pallas_gn.pack_scalars(pose, cfg, mode),
        mode, k, interpret=True)
    args = [_t(a) for a in (pts, mask, cand, ok, w)]
    sc = gn_cuda.pack_scalars(_t(pose), SlamConfig().matching, mode)
    H, g, nv = gn_cuda.gn_partials(*args, sc, mode, k)
    assert int(nv_j) > 100  # the case exercises the math
    assert int(nv) == int(nv_j)
    H_j, g_j = np.asarray(H_j), np.asarray(g_j)
    scale = np.abs(H_j).max() + 1e-9
    np.testing.assert_allclose(H.numpy() / scale, H_j / scale, atol=GN_ATOL)
    gscale = np.abs(g_j).max() + 1e-9
    np.testing.assert_allclose(g.numpy() / gscale, g_j / gscale,
                               atol=GN_ATOL)


@pytest.mark.parametrize("weighted", [False, True])
def test_gn_iteration_plain_matches_pallas_interpret(weighted):
    """One GN iteration over both clouds (the kernel's single launch on
    the card; on the CPU the plain version per cloud, summed) against the
    JAX gn_iteration_hg in Pallas interpret mode, weights given or None
    (ones): H and g to GN_ATOL scaled, n_valid exact."""
    c = _case("corner", seed=3)
    s = _case("surf", seed=4)
    cfg, pose, k = c[0], c[1], c[7]
    cw, sw = (c[6], s[6]) if weighted else (None, None)
    H_j, g_j, nv_j = pallas_gn.gn_iteration_hg(
        pose, *c[2:6], *s[2:6], cw, sw, cfg, k)
    tw = [None if w is None else _t(w) for w in (cw, sw)]
    H, g, nv = gn_cuda.gn_iteration_hg(
        _t(pose), *(_t(a) for a in c[2:6]), *(_t(a) for a in s[2:6]), *tw,
        SlamConfig().matching, k)
    vec = gn_cuda.gn_iteration_vec(
        _t(pose), *(_t(a) for a in c[2:6]), *(_t(a) for a in s[2:6]), *tw,
        SlamConfig().matching, k)
    assert int(nv_j) > 200 and nv.dtype == torch.int32
    assert int(nv) == int(nv_j) == int(vec[42])
    assert torch.equal(vec[:36].reshape(6, 6), H) and torch.equal(vec[36:42], g)
    H_j, g_j = np.asarray(H_j), np.asarray(g_j)
    scale = np.abs(H_j).max() + 1e-9
    np.testing.assert_allclose(H.numpy() / scale, H_j / scale, atol=GN_ATOL)
    gscale = np.abs(g_j).max() + 1e-9
    np.testing.assert_allclose(g.numpy() / gscale, g_j / gscale,
                               atol=GN_ATOL)


def test_scalar_rows_match_pack_scalars():
    """The two host rows of a K2 launch are pack_scalars' corner and surf
    rows, bit for bit."""
    pose = _t(np.array([0.02, -0.01, 0.05, 0.3, -0.2, 0.04], np.float32))
    cfg = SlamConfig().matching
    rows = gn_cuda.scalar_rows(pose, cfg)
    assert rows.shape == (2, 64) and rows.device.type == "cpu"
    assert torch.equal(rows[0], gn_cuda.pack_scalars(pose, cfg, "corner"))
    assert torch.equal(rows[1], gn_cuda.pack_scalars(pose, cfg, "surf"))


def test_gn_wrapper_checks_inputs():
    cfg, pose, pts, mask, cand, ok, w, k = _case("surf", seed=3)
    args = [_t(a) for a in (pts, mask, cand, ok, w)]
    sc = gn_cuda.pack_scalars(_t(pose), SlamConfig().matching, "surf")
    with pytest.raises(ValueError):
        gn_cuda.gn_partials(*args, sc, "edge", k)
    with pytest.raises(ValueError):
        gn_cuda.gn_partials(*args, sc[:63], "surf", k)
    with pytest.raises(TypeError):
        gn_cuda.gn_partials(args[0].double(), *args[1:], sc, "surf", k)
    with pytest.raises(ValueError):
        gn_cuda.gn_partials(*args, sc, "surf", k + 1)


def test_rerank_lowest_slot_wins_ties():
    """lax.top_k keeps the lowest index among equal distances; the port's
    stable sort must pick the same slots."""
    r = np.random.default_rng(5)
    pts = r.normal(size=(64, 3)).astype(np.float32)
    cand = np.repeat(r.normal(size=(64, 4, 3)), 2, axis=1).astype(np.float32)
    ok = r.uniform(size=(64, 8)) > 0.2
    dj, sj = jsm._rerank_neighbors(jnp.asarray(pts), jnp.asarray(cand),
                                   jnp.asarray(ok), 5)
    dt, st = tsm._rerank_neighbors(_t(pts), _t(cand), _t(ok), 5)
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-6)


def test_morton_sort_queries_match():
    r = np.random.default_rng(6)
    pts = r.uniform(-20, 20, (500, 3)).astype(np.float32)
    pts[::7] = pts[::7].round()  # repeated cells: order within a key
    mask = r.uniform(size=500) > 0.2
    w = r.uniform(size=500).astype(np.float32)
    pj, mj, wj = jsm._morton_sort_queries(jnp.asarray(pts), jnp.asarray(mask),
                                          jnp.asarray(w))
    pt, mt, wt = tsm._morton_sort_queries(_t(pts), _t(mask), _t(w))
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    np.testing.assert_array_equal(wt.numpy(), np.asarray(wj))


def test_rotation_jacobians_and_solve_match():
    rpy = np.array([0.3, -0.2, 1.1], np.float32)
    for mj, mt in zip(jsm._rotation_jacobian_mats(jnp.asarray(rpy)),
                      tsm._rotation_jacobian_mats(_t(rpy))):
        np.testing.assert_allclose(mt.numpy(), np.asarray(mj), atol=1e-6)
    cfg, pose, pts, mask, cand, ok, w, k = _case("surf", seed=3)
    H, g, nv = pallas_gn.gn_partials(
        pts, mask, cand, ok, w, pallas_gn.pack_scalars(pose, cfg, "surf"),
        "surf", k, interpret=True)
    out_j = jsm.gn_solve_from_hg(pose, H, g, nv.astype(jnp.int32), cfg)
    out_t = tsm.gn_solve_from_hg(_t(pose), _t(H), _t(g), int(nv),
                                 SlamConfig().matching)
    np.testing.assert_allclose(out_t[0].numpy(), np.asarray(out_j[0]),
                               atol=1e-5)
    assert out_t[2] == bool(out_j[2]) and out_t[3] == bool(out_j[3])
    np.testing.assert_allclose(out_t[5:], [float(out_j[5]),
                                           float(out_j[6])], rtol=1e-3)


@pytest.fixture(scope="module")
def solve_case():
    rng = np.random.default_rng(7)
    corner_map = _line_world(rng)
    surf_map = _plane_world(rng)
    pose_true = np.array([0.01, -0.02, 0.08, 0.5, -0.3, 0.05], np.float32)
    T_inv = jse3.transform_inverse(jse3.pose_to_matrix(jnp.asarray(
        pose_true)))

    def sensor_cloud(world_pts, n):
        sel = world_pts[rng.integers(0, len(world_pts), n)]
        return np.asarray(jse3.transform_points(T_inv, jnp.asarray(sel)))

    c_pts = sensor_cloud(corner_map, 256)
    s_pts = sensor_cloud(surf_map, 512)
    guess = pose_true + np.array([0.004, 0.003, -0.01, 0.1, -0.06, 0.02],
                                 np.float32)
    return corner_map, surf_map, c_pts, s_pts, guess, pose_true


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_scan_to_map_matches_jax(solve_case, backend):
    corner_map, surf_map, c_pts, s_pts, guess, pose_true = solve_case
    arrays = (guess, c_pts, np.ones(len(c_pts), bool), s_pts,
              np.ones(len(s_pts), bool), corner_map,
              np.ones(len(corner_map), bool), surf_map,
              np.ones(len(surf_map), bool))
    jcfg = dataclasses.replace(JSlamConfig().matching, gn_backend=backend)
    tcfg = dataclasses.replace(SlamConfig().matching, gn_backend=backend)
    out_j = jsm.scan_to_map(*(jnp.asarray(a) for a in arrays), jcfg, 15)
    out_t = tsm.scan_to_map(*(_t(a) for a in arrays), tcfg, 15)
    np.testing.assert_allclose(out_t.pose.numpy(), np.asarray(out_j.pose),
                               atol=POSE_ATOL)
    np.testing.assert_allclose(out_t.pose.numpy(), pose_true, atol=2e-2)
    assert out_t.converged and bool(out_j.converged)
    assert abs(out_t.n_valid - int(out_j.n_valid)) <= 0.02 * out_t.n_valid
