"""Port parity of the full SLAM system (pipeline/slam.py) against
lis_slam_tpu/pipeline/slam.py, on 16-beam scans of the bench's plaza lap
(tests/_torch_plaza.py renders them) with ground-truth
labels and injected yaw drift.

- One `slam_step` keyframe branch from a carried JAX FusedState: the
  front-end pose (5e-3 m / 5e-4 rad, the odometry step's bounds), the
  refined pose (2e-3 m), the per-feature labels, the class clouds' masks,
  and the descriptor and signature.
- A 40-scan SemanticSlam run (before any revisit) in both packages:
  submaps within +-1, and the port's raw and corrected ATE <= 1.5 x the
  JAX package's + 0.02 m.
- The whole lap plus 20 scans past the closure (`slow`: on a shared 8-core CPU
  the JAX reference alone took 209-259 s and the port 252-398 s, run side
  by side): both detect >= 1 loop, submaps within +-1, ATE as above.
- The paths the port does not run raise NotImplementedError; RangeNet
  inference sets up as the JAX package's does.
"""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp
import torch

from lis_slam_tpu.pipeline import driver as jdriver, slam as jslam
from lis_slam_tpu.pipeline import trajectory as jtraj
from lis_slam_tpu.config import SemanticConfig as JSemanticConfig
from lis_slam_tpu.semantic import weights as JW
from lis_slam_torch.config import SemanticConfig, lio_config
from lis_slam_torch.pipeline import (convert, driver, lio, odometry,
                                     semantic_odometry, slam, trajectory)
from lis_slam_torch.semantic import weights as W
from lis_slam_torch.utils import profiling, se3_np

from _torch_plaza import render_plaza, tiny_cfgs

POS_ATOL, ANG_ATOL = 5e-3, 5e-4  # the front-end step's bounds
REFINED_ATOL = 2e-3
DRIFT = 0.0015  # rad of yaw per scan about the origin
N_SHORT = 40


def drift_hook(pose6, idx):
    th = DRIFT * idx
    c, s = np.cos(th), np.sin(th)
    Td = np.eye(4)
    Td[:2, :2] = [[c, -s], [s, c]]
    return se3_np.matrix_to_pose(Td @ se3_np.pose_to_matrix(pose6))


def cfgs():
    """tiny_cfgs with the candidate gate widened to the injected drift
    (tests/test_slam_pipeline.py:182-190)."""
    j, t = tiny_cfgs()
    return (j.replace(loop=dataclasses.replace(j.loop,
                                               inflation_covariance=0.08)),
            t.replace(loop=dataclasses.replace(t.loop,
                                               inflation_covariance=0.08)))


def _run(mod, drv, cfg, scans, **kw):
    system = mod.SemanticSlam(cfg, pose_hook=drift_hook, **kw)
    for i, s in enumerate(scans):
        system.process_scan(drv.pad_scan(s.points[s.valid], cfg),
                            gt_labels=s.labels[s.valid], timestamp=i * 0.1)
    return system, system.finish()


def _compare_runs(jres, tres, gt_rel, min_loops):
    a_raw = trajectory.ate_rmse(tres.raw_poses, gt_rel, align=True)
    a_cor = trajectory.ate_rmse(tres.poses, gt_rel, align=True)
    j_raw = jtraj.ate_rmse(jres.raw_poses, gt_rel, align=True)
    j_cor = jtraj.ate_rmse(jres.poses, gt_rel, align=True)
    assert np.isfinite(tres.poses).all()
    assert abs(tres.n_submaps - jres.n_submaps) <= 1
    assert a_raw <= 1.5 * j_raw + 0.02, (a_raw, j_raw)
    assert a_cor <= 1.5 * j_cor + 0.02, (a_cor, j_cor)
    assert tres.n_loops >= min_loops and jres.n_loops >= min_loops
    return a_raw, a_cor


@pytest.fixture(scope="module")
def short_runs():
    jcfg, tcfg = cfgs()
    scans, gt = render_plaza(N_SHORT)
    js, jres = _run(jslam, jdriver, jcfg, scans)
    ts, tres = _run(slam, driver, tcfg, scans, device="cpu")
    return scans, gt, (js, jres), (ts, tres)


def test_short_run_matches_jax(short_runs):
    _scans, gt, (js, jres), (ts, tres) = short_runs
    gt_rel = trajectory.relative_to_first(gt[:N_SHORT])
    _compare_runs(jres, tres, gt_rel, min_loops=0)
    assert tres.poses.shape == (N_SHORT, 6)
    assert abs(len(ts.keyframes) - len(js.keyframes)) <= 2
    assert tres.n_submaps >= 2  # a registration factor was consumed
    assert len(ts.graph.edges) == len(js.graph.edges)
    # the injected drift reached the raw trajectory
    assert trajectory.ate_rmse(tres.raw_poses, gt_rel, align=False) > 0.05
    assert set(tres.stage_ms) >= {"odom_step", "drain", "keyframe",
                                  "submap_register", "graph_optimize"}


def test_global_map_and_kitti_export(short_runs, tmp_path):
    _scans, _gt, (js, _jres), (ts, tres) = short_runs
    m = ts.build_global_map()
    assert m.shape[1] == 4 and len(m) > 1000
    assert set(np.unique(m[:, 3]).astype(int)) <= {10, 40, 50, 70, 81}
    p, pj = tmp_path / "port.txt", tmp_path / "jax.txt"
    trajectory.write_kitti(str(p), tres.poses)
    jtraj.write_kitti(str(pj), tres.poses)
    np.testing.assert_allclose(np.loadtxt(p), np.loadtxt(pj), atol=1e-5)
    assert np.loadtxt(p).shape == (N_SHORT, 12)


def test_host_state_snapshots_round_trip(short_runs):
    """The JAX run's host state read by the convert snapshots, loaded into
    the port, read back equal."""
    _scans, _gt, (js, _jres), (ts, _tres) = short_runs
    jcfg, tcfg = cfgs()
    det = convert.loop_detector_from_numpy(
        convert.loop_detector_to_numpy(js.loop_detector), tcfg.loop)
    a, b = (convert.loop_detector_to_numpy(x) for x in (det,
                                                         js.loop_detector))
    assert a["travel"] == b["travel"] and a["n_stored"] == b["n_stored"]
    for x, y in zip(a["descs"] + a["sigs"], b["descs"] + b["sigs"]):
        np.testing.assert_array_equal(x, y)
    kfs = [convert.keyframe_from_numpy(convert.keyframe_to_numpy(k))
           for k in js.keyframes]
    col = convert.collector_from_numpy(convert.collector_to_numpy(
        js.collector), tcfg.submap, kfs)
    ca, cb = (convert.collector_to_numpy(c) for c in (col, js.collector))
    assert ca["cur_kfs"] == cb["cur_kfs"] and len(ca["submaps"]) == len(
        cb["submaps"])
    for sa, sb in zip(ca["submaps"], cb["submaps"]):
        for f in ("surf_xyz", "surf_mask", "class_xyz", "class_w"):
            np.testing.assert_array_equal(sa[f], sb[f], err_msg=f)
    gb = convert.graph_builder_from_numpy(
        convert.graph_builder_to_numpy(js.graph), ts.graph)
    np.testing.assert_array_equal(np.stack(gb.nodes), np.stack(js.graph.nodes))


def test_slam_step_keyframe_from_carried_state():
    """Step the JAX package over the first scans; at the first keyframe
    after the semantic map has content, carry its FusedState into the port
    and run that scan through both slam_step branches."""
    jcfg, tcfg = cfgs()
    scans, _gt = render_plaza(12, seed0=600)
    fstate = jslam.SemanticSlam(jcfg).fstate
    compared = 0
    for i, s in enumerate(scans):
        lab = np.zeros(jcfg.sensor.max_raw_points, np.int32)
        lab[:int(s.valid.sum())] = s.labels[s.valid]
        snap = convert.fused_state_to_numpy(fstate)
        sin = jdriver.pad_scan(s.points[s.valid], jcfg)
        fstate, out_j = jslam.slam_step(fstate, sin, jnp.asarray(lab), None,
                                        jcfg, "gt")
        if not (bool(out_j.is_keyframe) and int(snap["sem"]["kf_count"]) >= 3):
            continue
        st = convert.fused_state_from_numpy(snap)
        st2, out_t = slam.slam_step(
            st, driver.pad_scan(s.points[s.valid], tcfg),
            torch.from_numpy(lab), tcfg, "gt")
        assert out_t.is_keyframe
        p, pj = out_t.pose.numpy(), np.asarray(out_j.pose)
        np.testing.assert_allclose(p[3:], pj[3:], atol=POS_ATOL)
        np.testing.assert_allclose(p[:3], pj[:3], atol=ANG_ATOL)
        np.testing.assert_allclose(out_t.refined.numpy(),
                                   np.asarray(out_j.refined),
                                   atol=REFINED_ATOL)
        np.testing.assert_array_equal(out_t.lab_surf.numpy(),
                                      np.asarray(out_j.lab_surf))
        np.testing.assert_array_equal(out_t.surf_mask.numpy(),
                                      np.asarray(out_j.surf_mask))
        cm, cmj = out_t.class_mask.numpy(), np.asarray(out_j.class_mask)
        np.testing.assert_array_equal(cm.sum(1), cmj.sum(1))
        np.testing.assert_array_equal(out_t.signature.numpy()[:, 0],
                                      np.asarray(out_j.signature)[:, 0])
        assert np.abs(out_t.desc_sel.numpy()
                      - np.asarray(out_j.desc_sel)).mean() < 0.5
        assert int(st2.sem.kf_count) == int(snap["sem"]["kf_count"]) + 1
        np.testing.assert_allclose(st2.last_refined.numpy(),
                                   out_t.refined.numpy())
        compared += 1
        if compared == 2:
            break
    assert compared >= 1


@pytest.mark.slow
def test_loop_closure_run_matches_jax():
    jcfg, tcfg = cfgs()
    lap, extra = 100, 20
    scans, gt = render_plaza(lap)
    scans2, _ = render_plaza(extra, seed0=700)
    seq = scans + scans2
    gt_rel = trajectory.relative_to_first(
        np.concatenate([gt[:lap], gt[:extra]]))
    _js, jres = _run(jslam, jdriver, jcfg, seq)
    _ts, tres = _run(slam, driver, tcfg, seq, device="cpu")
    _raw, cor = _compare_runs(jres, tres, gt_rel, min_loops=1)
    assert cor < trajectory.ate_rmse(tres.raw_poses, gt_rel, align=True)


def test_unported_paths_raise():
    """IMU, GPS, debug_dir and predict_imu_rate raise NotImplementedError.
    RangeNet inference is ported: `rangenet_params` (with semantics on),
    and cfg.semantic.enabled without them (the in-repo checkpoint and its
    architecture), set up the same weights and inference config as the JAX
    package's SemanticSlam; a scan without labels then runs lab_mode
    "infer" on its keyframe."""
    jcfg, tcfg = cfgs()
    with pytest.raises(NotImplementedError):
        slam.SemanticSlam(tcfg.replace(imu=dataclasses.replace(
            tcfg.imu, use_imu=True)), device="cpu")
    with pytest.raises(NotImplementedError):
        slam.SemanticSlam(tcfg, debug_dir="/nonexistent", device="cpu")
    system = slam.SemanticSlam(tcfg, device="cpu")
    with pytest.raises(NotImplementedError):
        system.add_gps(np.zeros(3), np.ones(3))
    with pytest.raises(NotImplementedError):
        system.predict_imu_rate(np.zeros(4), np.zeros((4, 3)),
                                np.zeros((4, 3)))
    scans, _gt = render_plaza(1)
    sin = driver.pad_scan(scans[0].points[scans[0].valid], tcfg)
    with pytest.raises(NotImplementedError):
        system.process_scan(sin, imu_time=np.zeros(4))
    with pytest.raises(ValueError):  # "infer" needs a model
        slam.slam_step(system.fstate, sin, None, tcfg, "infer")

    sem_cfg, tree = W.load_checkpoint()
    jsem_cfg, jtree = JW.load_checkpoint()
    pairs = {
        "params": (slam.SemanticSlam(tcfg.replace(semantic=sem_cfg),
                                     rangenet_params=tree, device="cpu"),
                   jslam.SemanticSlam(jcfg.replace(semantic=jsem_cfg),
                                      rangenet_params=jtree)),
        "enabled": (slam.SemanticSlam(tcfg.replace(semantic=SemanticConfig(
            enabled=True)), device="cpu"),
                    jslam.SemanticSlam(jcfg.replace(semantic=JSemanticConfig(
                        enabled=True)))),
    }
    for name, (ts, js) in pairs.items():
        assert ts.model is not None and js.model is not None, name
        assert (dataclasses.asdict(ts._infer_cfg)
                == dataclasses.asdict(js._infer_cfg)), name
        want = W.to_torch_state(js.model_vars, ts._infer_cfg.semantic)
        for k, v in ts.model.state_dict().items():
            torch.testing.assert_close(v, want[k].to(v.dtype), rtol=0,
                                       atol=0, msg=k)
    # parameters without semantics on label nothing, as in the JAX package
    assert slam.SemanticSlam(tcfg, rangenet_params=tree,
                             device="cpu").model is None
    assert jslam.SemanticSlam(jcfg, rangenet_params=jtree).model is None

    sem_on = pairs["enabled"][0]
    sem_on.process_scan(sin)
    out = sem_on._pending[0].out
    assert out.is_keyframe and sem_on.collector.merge_classes
    lab = out.lab_surf[out.surf_mask]
    assert float((lab > 0).float().mean()) > 0.5
    assert int(out.class_mask.sum()) > 1000


def test_entry_points_default_to_the_card():
    """Without a device argument the entry points ask for CUDA: on a
    machine without it they raise instead of running on the host."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is valid")
    _jcfg, tcfg = cfgs()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        slam.SemanticSlam(tcfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        slam.init_fused_state(tcfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        driver.replay_odometry([], tcfg)
    for build in (odometry.init_state, semantic_odometry.init_state):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build(tcfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lio.LioOdometry(lio_config())
    assert slam.init_fused_state(tcfg, "cpu").odom.pose.device.type == "cpu"


def test_stage_timer():
    t = profiling.StageTimer()
    for _ in range(3):
        with t.stage("a"):
            pass
    with t.stage("b"):
        sum(range(10000))
    r = t.report()
    assert list(r) == ["a", "b"] and r["a"]["count"] == 3
    assert r["b"]["total_ms"] >= r["b"]["mean_ms"] > 0
