"""Port parity of the GPS path, the debug dump and the matrix-free graph
solve of SemanticSlam (pipeline/slam.py add_gps/_drain_gps, viz/debug.py,
graph/pose_graph.py optimize_cg) against lis_slam_tpu.

- add_gps's covariance gate and queue, on fresh systems of both packages.
- _drain_gps on the same hand-built submap set in both packages: the same
  (node, T, sigma) priors within 1e-6, the same dropped count and queue,
  fixes that wait for a later submap; NavsatPipeline.feed_slam (the port's
  copy of pipeline/navsat.py) into the port's SemanticSlam.
- A 6-scan run of both packages with `debug_dir`, GPS fixes and
  build_map: the same debug file set, the descriptor images and loop
  markers read back, priors on the same nodes.
- optimize_cg on a 64-node drifted square with a GPS prior against the
  JAX package's optimize_cg (1e-3) and the port's dense LM (5e-3).
"""

import dataclasses
import json
import os

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp
import torch

from lis_slam_tpu.config import GraphConfig as JGraphConfig
from lis_slam_tpu.graph import pose_graph as jpg
from lis_slam_tpu.mapping import submap as jsm
from lis_slam_tpu.pipeline import driver as jdriver, navsat as jnavsat
from lis_slam_tpu.pipeline import slam as jslam
from lis_slam_torch.config import GraphConfig
from lis_slam_torch.graph import pose_graph as tpg
from lis_slam_torch.mapping import submap as tsm
from lis_slam_torch.pipeline import driver, navsat, slam
from lis_slam_torch.utils import se3, se3_np
from lis_slam_torch.viz import debug

from _torch_plaza import render_plaza, tiny_cfgs

PRIOR_ATOL = 1e-6
CG_JAX_ATOL = 1e-3
CG_DENSE_ATOL = 5e-3


def _systems():
    jcfg, tcfg = tiny_cfgs()
    return jslam.SemanticSlam(jcfg), slam.SemanticSlam(tcfg, device="cpu")


def _priors(system):
    return [(i, np.asarray(T), np.asarray(w)) for i, T, w in
            system.graph.priors]


def _assert_same_priors(jsys, tsys):
    pj, pt = _priors(jsys), _priors(tsys)
    assert len(pj) == len(pt)
    for (ij, Tj, wj), (it, Tt, wt) in zip(pj, pt):
        assert ij == it
        np.testing.assert_allclose(Tt, Tj, atol=PRIOR_ATOL)
        np.testing.assert_allclose(wt, wj, rtol=1e-6)


def test_add_gps_gate_matches_jax():
    jsys, tsys = _systems()
    calls = [
        (np.zeros(3), np.full(3, 0.1), None),  # no submap yet
        (np.ones(3), np.full(3, 100.0), 0.3),  # over the gate
        (np.ones(3), np.array([0.1, 3.0, 0.1]), 0.4),  # y over the gate
        (np.ones(3), np.array([0.1, 0.1, 50.0]), 0.5),  # z is not gated
        (np.array([1.0, 2.0, 0.5]), np.full(3, 0.1), 0.6),
    ]
    got = [(jsys.add_gps(p, c, t), tsys.add_gps(p, c, t))
           for p, c, t in calls]
    assert [a for a, _ in got] == [b for _, b in got] == [
        False, False, False, True, True]
    assert len(jsys._gps_queue) == len(tsys._gps_queue) == 2
    for a, b in zip(jsys._gps_queue, tsys._gps_queue):
        assert a[0] == b[0]
        np.testing.assert_array_equal(a[1], b[1])
        np.testing.assert_array_equal(a[2], b[2])


def _pose(x, y, yaw):
    return se3_np.pose_to_matrix(np.array([0.0, 0.0, yaw, x, y, 0.0]))


def _add_submaps(system, kf_mod, sm_mod, zeros, times, n_per):
    """Keyframes along a curve at `times`, grouped n_per to a submap."""
    r = np.random.default_rng(4)
    base = len(system.keyframes)
    for k, t in enumerate(times):
        T = _pose(2.0 * (base + k), 0.3 * (base + k) ** 1.5,
                  0.05 * (base + k) + r.normal(0, 0.01))
        kf = sm_mod.Keyframe(index=base + k, pose_init=T, pose_opt=T.copy(),
                             clouds=None, corner_xyz=zeros((4, 3)),
                             corner_mask=zeros(4, bool),
                             surf_xyz=zeros((4, 3)), surf_mask=zeros(4, bool),
                             timestamp=t)
        system.keyframes.append(kf)
    for s0 in range(base, base + len(times), n_per):
        ids = list(range(s0, min(s0 + n_per, base + len(times))))
        T0 = system.keyframes[ids[0]].pose_init
        s = sm_mod.SubMap(index=len(system.collector.submaps), pose_init=T0,
                          pose_opt=T0.copy(), corner_xyz=zeros((4, 3)),
                          corner_mask=zeros(4, bool),
                          surf_xyz=zeros((4, 3)), surf_mask=zeros(4, bool),
                          kf_indices=ids,
                          kf_rel_poses=[np.linalg.inv(T0)
                                        @ system.keyframes[i].pose_init
                                        for i in ids])
        for i in ids:
            system.keyframes[i].submap_id = s.index
        system.collector.submaps.append(s)
        system.graph.add_node(T0)


def _jzeros(shape, dtype=np.float32):
    return jnp.zeros(shape, dtype)


def _tzeros(shape, dtype=np.float32):
    return torch.from_numpy(np.zeros(shape, dtype))


def test_drain_gps_matches_jax():
    """The same submaps and fixes in both packages: the same priors, drops
    and waiting fixes, through submap closes."""
    jsys, tsys = _systems()
    times = [0.0, 0.5, 1.0, 1.5, 2.5, 3.0, 3.5, 4.0]  # gap at 2.0
    r = np.random.default_rng(8)
    fixes = [(t, r.normal(0, 5, 3), np.full(3, 0.04))
             for t in (0.05, 0.45, 1.6, 2.05, 3.1, 4.4, 5.1, 6.0)]
    for system, mod, zeros in ((jsys, jsm, _jzeros), (tsys, tsm, _tzeros)):
        _add_submaps(system, mod.Keyframe, mod, zeros, times[:4], 2)
        for t, p, c in fixes:
            assert system.add_gps(p, c, timestamp=t)
    _assert_same_priors(jsys, tsys)
    assert jsys._gps_dropped == tsys._gps_dropped
    assert len(jsys._gps_queue) == len(tsys._gps_queue) > 0
    # more submaps close: the waiting fixes attach (or drop in the gap)
    for system, mod, zeros in ((jsys, jsm, _jzeros), (tsys, tsm, _tzeros)):
        _add_submaps(system, mod.Keyframe, mod, zeros, times[4:], 2)
        system._drain_gps()
    _assert_same_priors(jsys, tsys)
    assert jsys._gps_dropped == tsys._gps_dropped >= 1
    assert [q[0] for q in jsys._gps_queue] == [q[0] for q in
                                               tsys._gps_queue]
    assert len(tsys.graph.priors) > 1 + 2  # anchor + matched fixes


def test_navsat_feed_slam_matches_jax():
    """NavsatPipeline (the port's copy) -> add_gps: the filtered samples
    land in the port's SemanticSlam queue as the JAX pipeline's do."""
    jsys, tsys = _systems()
    pipes = (jnavsat.NavsatPipeline(), navsat.NavsatPipeline())
    for k in range(5):
        for pipe in pipes:
            pipe.on_imu(k * 0.1, np.zeros(3), 0.0, np.zeros(3))
            pipe.on_fix(k * 0.1, 48.0 + k * 1e-6, 11.0, 0.0, np.full(3, 1.0))
    pipes[0].feed_slam(jsys)
    pipes[1].feed_slam(tsys)
    assert not pipes[1].stream
    assert len(tsys._gps_queue) == len(jsys._gps_queue) == 5
    for a, b in zip(jsys._gps_queue, tsys._gps_queue):
        assert a[0] == b[0]
        np.testing.assert_allclose(b[1], a[1], atol=1e-9)
        np.testing.assert_allclose(b[2], a[2], atol=1e-12)


N_DEBUG = 6


def _debug_run(mod, drv, cfg, scans, gt_rel, out_dir, **kw):
    system = mod.SemanticSlam(cfg, debug_dir=out_dir, **kw)
    for i, s in enumerate(scans):
        system.process_scan(drv.pad_scan(s.points[s.valid], cfg),
                            timestamp=i * 0.1)
        if i % 2 == 0:
            system.add_gps(gt_rel[i, 3:], np.full(3, 0.01), timestamp=i * 0.1)
    res = system.finish(build_map=True)
    return system, res


def test_debug_dump_and_gps_run_match_jax(tmp_path):
    jcfg, tcfg = tiny_cfgs()
    scans, gt = render_plaza(N_DEBUG, seed0=800)
    from lis_slam_torch.pipeline import trajectory

    gt_rel = trajectory.relative_to_first(gt[:N_DEBUG])
    jd, td = str(tmp_path / "jax"), str(tmp_path / "port")
    jsys, _jres = _debug_run(jslam, jdriver, jcfg, scans, gt_rel, jd)
    tsys, tres = _debug_run(slam, driver, tcfg, scans, gt_rel, td,
                            device="cpu")
    assert sorted(os.listdir(td)) == sorted(os.listdir(jd))
    names = sorted(os.listdir(td))
    pgms = [n for n in names if n.endswith(".pgm")]
    assert len(pgms) == len(tsys.keyframes) >= 3
    for n in pgms:
        a, b = debug.read_pgm(os.path.join(td, n)), debug.read_pgm(
            os.path.join(jd, n))
        assert a.shape == b.shape and a.size > 0
        assert np.abs(a.astype(np.int32) - b).mean() < 8.0, n
    with open(os.path.join(td, "loop_edges.json")) as f:
        assert json.load(f) == []
    with open(os.path.join(td, "loop_markers.ply")) as f:
        assert "element edge 0" in f.read()
    from lis_slam_torch.io import kitti

    cloud = kitti.read_pcd(os.path.join(td, "global_map.pcd"))
    assert cloud.shape == (len(tres.global_map), 4)  # xyz + label
    # the fixes became priors on the same submap nodes
    assert ([i for i, _T, _w in tsys.graph.priors]
            == [i for i, _T, _w in jsys.graph.priors])
    assert len(tsys.graph.priors) > 1
    assert tsys._gps_dropped == jsys._gps_dropped


def _drifted_square(gb, n_nodes):
    """tests/test_loop_graph.py's square loop with biased odometry and one
    exact loop closure."""
    gt = []
    for k in range(n_nodes):
        yaw = (np.pi / 2) * ((4 * k // n_nodes) % 4)
        frac = (k % (n_nodes // 4)) / (n_nodes // 4)
        side = 4 * k // n_nodes
        t = {0: (10 * frac, 0), 1: (10, 10 * frac),
             2: (10 - 10 * frac, 10), 3: (0, 10 - 10 * frac)}[side]
        gt.append(_pose(t[0], t[1], yaw).astype(np.float32))
    bias = se3.se3_exp(torch.tensor(
        [0.02, 0.01, 0.0, 0.0, 0.0, 0.002])).numpy()
    est = [gt[0]]
    gb.add_node(gt[0])
    for k in range(1, n_nodes):
        z = (np.linalg.inv(gt[k - 1]) @ gt[k]) @ bias
        est.append(est[-1] @ z)
        gb.add_node(est[-1])
        gb.add_odom_edge(k - 1, k, z)
    gb.add_loop_edge(n_nodes - 1, 0, np.linalg.inv(gt[-1]) @ gt[0],
                     scale=100.0)
    gb.add_gps_prior(n_nodes // 2, gt[n_nodes // 2], np.full(3, 0.01))
    return gt, est


def test_cg_with_gps_prior_matches_jax_and_dense():
    n = 64
    out = {}
    for name, gb in (
            ("jax", jpg.GraphBuilder(dataclasses.replace(JGraphConfig(),
                                                         solver="cg"),
                                     max_nodes=n, max_edges=2 * n)),
            ("cg", tpg.GraphBuilder(dataclasses.replace(GraphConfig(),
                                                        solver="cg"),
                                    max_nodes=n, max_edges=2 * n)),
            ("dense", tpg.GraphBuilder(dataclasses.replace(
                GraphConfig(), solver="dense"), max_nodes=n,
                max_edges=2 * n))):
        gt, est = _drifted_square(gb, n)
        out[name] = gb.optimize()
    np.testing.assert_allclose(out["cg"], out["jax"], atol=CG_JAX_ATOL)
    np.testing.assert_allclose(out["cg"], out["dense"], atol=CG_DENSE_ATOL)
    before = np.linalg.norm(est[-1][:3, 3] - gt[-1][:3, 3])
    after = np.linalg.norm(out["cg"][-1][:3, 3] - gt[-1][:3, 3])
    assert after < 0.5 * before, (before, after)
