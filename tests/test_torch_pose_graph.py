"""Port parity of the pose graph (graph/pose_graph.py) against
lis_slam_tpu/graph/pose_graph.py: the LM with the GNC-annealed Cauchy
kernel on a 12-node loop with noisy odometry, one true loop edge, one
false (robust) loop edge and a GPS prior; nodes within 1e-4 after the
same builder calls (same bucket padding). Also the adjoint, the
keyframe correction, and the matrix-free CG solver (solver "cg", or
"auto" past dense_max_nodes) against the JAX package's optimize_cg (1e-3)
and the port's dense solve (5e-3)."""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp
import torch

from lis_slam_tpu.config import GraphConfig as JGraphConfig
from lis_slam_tpu.graph import pose_graph as jpg
from lis_slam_tpu.utils import se3_np
from lis_slam_torch.config import GraphConfig
from lis_slam_torch.graph import pose_graph as tpg

NODE_ATOL = 1e-4


def _pose(x, y, yaw, z=0.0):
    return se3_np.pose_to_matrix(np.array([0.0, 0.0, yaw, x, y, z]))


def _build(builder, n=12, seed=0):
    """A drifting loop: nodes on a 20 m circle, odometry with noise, the
    closing loop edge, a false loop edge and a GPS prior."""
    r = np.random.default_rng(seed)
    truth = [_pose(20 * np.sin(a), 20 * (1 - np.cos(a)), a)
             for a in np.linspace(0, 2 * np.pi, n, endpoint=False)]
    est = [truth[0]]
    for i in range(1, n):
        rel = np.linalg.inv(truth[i - 1]) @ truth[i]
        noise = _pose(*r.normal(0, [0.05, 0.05, 0.01]))
        est.append(est[-1] @ rel @ noise)
    for T in est:
        builder.add_node(T)
    for i in range(1, n):
        builder.add_odom_edge(i - 1, i, np.linalg.inv(est[i - 1]) @ est[i])
    builder.add_loop_edge(n - 1, 0, np.linalg.inv(truth[n - 1]) @ truth[0],
                          scale=2.0)
    builder.add_loop_edge(6, 1, _pose(3.0, -2.0, 0.4), scale=1.0)  # false
    builder.add_gps_prior(4, truth[4], np.array([0.5, 0.5, 10.0]))
    return truth, est


def test_optimize_matches_jax():
    jb = jpg.GraphBuilder(JGraphConfig(), max_nodes=64, max_edges=256,
                          max_priors=64)
    tb = tpg.GraphBuilder(GraphConfig(), max_nodes=64, max_edges=256,
                          max_priors=64)
    truth, est = _build(jb)
    _build(tb)
    gj = jb.to_device()
    gt_ = tb.to_device()
    assert gt_.nodes.shape == gj.nodes.shape  # same bucket padding (16)
    assert gt_.edge_i.shape == gj.edge_i.shape
    nj = jb.optimize()
    nt = tb.optimize()
    np.testing.assert_allclose(nt, nj, atol=NODE_ATOL)
    # the true loop pulls the last node toward the truth; the false loop
    # is cut by the kernel (the solve does not obey it)
    assert (np.linalg.norm(nt[-1][:3, 3] - truth[-1][:3, 3])
            < np.linalg.norm(est[-1][:3, 3] - truth[-1][:3, 3]))
    false_rel = np.linalg.inv(nt[6]) @ nt[1]
    assert np.linalg.norm(false_rel[:2, 3] - [3.0, -2.0]) > 1.0
    # the optimized poses were installed on the builder
    np.testing.assert_array_equal(np.stack(tb.nodes), nt)


@pytest.mark.parametrize("iterations", [1, 4])
def test_optimize_sweeps_match_jax(iterations):
    """Inside the GNC anneal (before the early exit can fire)."""
    jb = jpg.GraphBuilder(JGraphConfig())
    tb = tpg.GraphBuilder(GraphConfig())
    _build(jb, seed=1)
    _build(tb, seed=1)
    g = jpg.optimize(jb.to_device(), iterations=iterations)
    t = tpg.optimize(tb.to_device(), iterations=iterations)
    np.testing.assert_allclose(t.nodes.numpy(), np.asarray(g.nodes),
                               atol=NODE_ATOL)


def test_adjoint_and_correction_match():
    r = np.random.default_rng(2)
    Ts = np.stack([_pose(*r.uniform(-5, 5, 3), z=r.uniform(-1, 1))
                   for _ in range(8)]).astype(np.float32)
    np.testing.assert_allclose(tpg.adjoint(torch.from_numpy(Ts)).numpy(),
                               np.asarray(jpg.adjoint(jnp.asarray(Ts))),
                               atol=1e-5)
    kf_sub = np.array([0, 0, 1, 1, 2, 2, 2, 1])
    sub_init, sub_opt = Ts[:3].astype(np.float64), Ts[3:6].astype(np.float64)
    np.testing.assert_allclose(
        tpg.correct_keyframe_poses(Ts, kf_sub, sub_init, sub_opt),
        jpg.correct_keyframe_poses(Ts, kf_sub, sub_init, sub_opt))


CG_JAX_ATOL = 1e-3
CG_DENSE_ATOL = 5e-3


@pytest.mark.parametrize("solver,max_nodes", [("cg", 64), ("auto", 512)])
def test_cg_solver_not_ported(solver, max_nodes):
    """The CG route (kept under its old name): the port's optimize_cg
    against the JAX package's on the same graph, and against the port's
    dense LM."""
    cfg = dataclasses.replace(GraphConfig(), solver=solver,
                              dense_max_nodes=8)
    jcfg = dataclasses.replace(JGraphConfig(), solver=solver,
                               dense_max_nodes=8)
    tb = tpg.GraphBuilder(cfg, max_nodes=max_nodes, cg_device="cpu")
    jb = jpg.GraphBuilder(jcfg, max_nodes=max_nodes)
    db = tpg.GraphBuilder(GraphConfig(solver="dense"), max_nodes=max_nodes)
    truth, est = _build(tb)
    _build(jb)
    _build(db)
    nt = tb.optimize()
    np.testing.assert_allclose(nt, jb.optimize(), atol=CG_JAX_ATOL)
    np.testing.assert_allclose(nt, db.optimize(), atol=CG_DENSE_ATOL)
    assert (np.linalg.norm(nt[-1][:3, 3] - truth[-1][:3, 3])
            < np.linalg.norm(est[-1][:3, 3] - truth[-1][:3, 3]))
    np.testing.assert_array_equal(np.stack(tb.nodes), nt)


def test_empty_graph_matches():
    gj = jpg.empty_graph(8, 16, 4)
    gt = tpg.empty_graph(8, 16, 4)
    for f in jpg.PoseGraph._fields:
        np.testing.assert_array_equal(getattr(gt, f).numpy(),
                                      np.asarray(getattr(gj, f)), err_msg=f)
        assert getattr(gt, f).shape == getattr(gj, f).shape
