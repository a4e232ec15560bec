"""The port's tracing (utils/profiling.py): stages that nest and know their
parent, profiler ranges `stage:<name>` only while a torch.profiler
records, and the counters (scans, host syncs, GN iterations), each kept
also by the innermost open stage.

The runs are tiny (16 x 360 beams, a few scans) on the CPU, where the
profiler records host ranges only and no sync warning comes from CUDA:
the sync count is fed synthetic warnings of CUDA's text.
"""

import ast
import dataclasses
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from lis_slam_torch.config import KeyframeConfig, SensorConfig, SlamConfig
from lis_slam_torch.config import lio_config
from lis_slam_torch.io import synthetic, synthetic_torch
from lis_slam_torch.parallel import batched
from lis_slam_torch.pipeline import driver, lio, odometry, slam
from lis_slam_torch.utils import profiling

PKG = Path(__file__).resolve().parents[1] / "lis_slam_torch"
VLP16 = np.linspace(15.0, -15.0, 16)
H = 360
SYNC = "called a synchronizing CUDA operation"


def _micro_cfg(base=None):
    """16 x 360 beams with the back end's buffers cut to that scale."""
    base = base or SlamConfig()
    return base.replace(
        sensor=dataclasses.replace(
            base.sensor, n_scan=16, horizon_scan=H, downsample_rate=1,
            lidar_min_range=1.0, lidar_max_range=80.0,
            max_raw_points=16 * H),
        feature=dataclasses.replace(
            base.feature, max_corner_points=512, max_surf_points=2048,
            max_sharp_corner_points=256, max_sharp_surf_points=512),
        matching=dataclasses.replace(
            base.matching, corner_map_capacity=4096, surf_map_capacity=8192,
            hash_table_slots=1 << 12, degeneracy_eigen_threshold=10.0),
        submap=dataclasses.replace(
            base.submap, corner_capacity=4096, surf_capacity=8192,
            local_corner_capacity=4096, local_surf_capacity=8192,
            max_submaps=16),
        keyframe=KeyframeConfig(min_distance=0.2, min_yaw=0.2))


def _render(n, distorted=False):
    """n 16-beam sweeps of the city along a 60 m circle: (points, labels)
    host arrays of the valid points, and the true poses."""
    world = synthetic_torch.to_device_world(synthetic.make_world(seed=5),
                                            "cpu")
    gt = synthetic.circular_trajectory(n + 1, radius=60.0, speed=8.0)
    gen = torch.Generator().manual_seed(7)
    out = []
    for i in range(n):
        pts, lab, valid = synthetic_torch.render_scan_device(
            world, torch.as_tensor(gt[i]), gen, n_scan=16, horizon=H,
            elevations=VLP16,
            next_pose6=torch.as_tensor(gt[i + 1]) if distorted else None)
        out.append((pts[valid].numpy(), lab[valid].numpy()))
    return out, gt


@pytest.fixture(scope="module")
def scans():
    return _render(4)


@pytest.fixture(autouse=True)
def _fresh_counters():
    profiling.reset_counters()
    yield
    profiling.reset_counters()


def _profile():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU], record_shapes=True)


def _stage_events(prof):
    return [e for e in prof.events() if e.name.startswith("stage:")]


def _ancestors(ev):
    out = []
    while ev.cpu_parent is not None:
        ev = ev.cpu_parent
        out.append(ev)
    return out


def test_stages_nest_and_know_their_parent():
    from lis_slam_tpu.utils import profiling as jprof

    timer = profiling.StageTimer()
    jtimer = jprof.StageTimer()
    with profiling.root(timer, "process_scan", scan=0):
        with profiling.span("odom_step"):
            with profiling.span("scan_to_map"):
                pass
            with timer.stage("kf_map_insert"):
                pass
        with profiling.span("odom_step"):
            pass
    for name in ("process_scan", "odom_step", "odom_step", "scan_to_map",
                 "kf_map_insert"):
        with jtimer.stage(name):
            pass
    parents = {k: v.parent for k, v in timer.stats.items()}
    assert parents == {"process_scan": None, "odom_step": "process_scan",
                       "scan_to_map": "odom_step",
                       "kf_map_insert": "odom_step"}
    assert timer.stats["odom_step"].count == 2 and not timer._open
    assert (timer.stats["process_scan"].total_s
            >= timer.stats["odom_step"].total_s)
    # the summary's format is the JAX module's, stage for stage
    for name, s in timer.stats.items():
        j = jtimer.stats[name]
        j.count, j.total_s, j.max_s = s.count, s.total_s, s.max_s
    assert timer.summary() == jtimer.summary()
    # a span outside any root charges no timer
    with profiling.span("alone"):
        pass
    assert "alone" not in timer.stats


def test_tracing_off_opens_no_range_and_counts_nothing(scans, monkeypatch):
    def no_range(*a, **kw):
        raise AssertionError("a profiler range opened with tracing off")

    monkeypatch.setattr(profiling, "_RecordFunctionFast", no_range)
    cfg = _micro_cfg()
    system = slam.SemanticSlam(cfg, device="cpu")
    for i, (pts, lab) in enumerate(scans[0][:2]):
        system.process_scan(driver.pad_scan(pts, cfg), gt_labels=lab,
                            timestamp=0.1 * i)
    with warnings.catch_warnings(record=True) as shown:
        warnings.simplefilter("always")
        with profiling.root(profiling.StageTimer(), "process_scan"):
            warnings.warn(SYNC)
    assert len(shown) == 1  # shown, not counted
    system.finish()
    assert profiling.counters() == dict.fromkeys(profiling.COUNTERS, 0)
    assert system.timer.stats["preprocess"].count == 2
    assert system.timer.stats["scan_to_map"].parent == "odom_step"


def test_slam_trace_nests_the_fused_step(scans):
    cfg = _micro_cfg()
    system = slam.SemanticSlam(cfg, device="cpu")
    with _profile() as prof:
        for i, (pts, lab) in enumerate(scans[0]):
            system.process_scan(driver.pad_scan(pts, cfg), gt_labels=lab,
                                timestamp=0.1 * i)
        system.finish()
    evs = _stage_events(prof)
    roots = [e for e in evs if e.name == "stage:process_scan"]
    assert [e.kwinputs for e in roots] == [{"scan": i} for i in range(4)]
    assert any(e.name == "stage:finish" for e in evs)
    for name in ("preprocess", "scan_to_map", "kf_map_insert",
                 "kf_semantic"):
        inner = [e for e in evs if e.name == f"stage:{name}"]
        assert inner, name
        for e in inner:
            up = [a.name for a in _ancestors(e)]
            assert up[-2:] == ["stage:odom_step", "stage:process_scan"], \
                (name, up)
    for name in ("semantic_refine", "descriptors"):
        inner = [e for e in evs if e.name == f"stage:{name}"]
        assert inner and all(e.cpu_parent.name == "stage:kf_semantic"
                             for e in inner), name
    assert profiling.counters("process_scan")["scans"] == 4
    assert profiling.counters()["scans"] == 4
    assert profiling.counters()["host_syncs"] == 0  # the CPU never waits
    assert system.timer.stats["kf_semantic"].parent == "odom_step"


def test_gn_iterations_count_the_front_end_solves(scans):
    cfg = _micro_cfg()
    state = odometry.init_state(cfg, "cpu")
    timer = profiling.StageTimer()
    iterations = []
    with _profile():
        for i, (pts, _lab) in enumerate(scans[0]):
            with profiling.root(timer, "process_scan", scan=i):
                state, out = odometry.odom_step(
                    state, driver.pad_scan(pts, cfg), cfg)
            iterations.append(out.iterations)
    assert sum(iterations) > len(iterations)
    assert profiling.counters("scan_to_map")["gn_iterations"] == \
        sum(iterations) == profiling.counters()["gn_iterations"]
    assert timer.stats["scan_to_map"].count == len(iterations)


def test_lio_spans_and_imu_seconds():
    cfg = _micro_cfg(lio_config())
    seq, gt = _render(3, distorted=True)
    system = lio.LioOdometry(cfg, device="cpu")
    with _profile() as prof:
        for i, (pts, _lab) in enumerate(seq):
            gyro, accel, imu_t = synthetic_torch.imu_rows(gt[i], gt[i + 1])
            system.process_scan(pts, imu_t + 0.1 * i, gyro, accel, 0.1 * i)
    st = system.timer.stats
    assert system.diag.imu_s == st["imu_chain"].total_s > 0
    assert st["imu_chain"].count == 2 * len(seq)
    assert {k: v.parent for k, v in st.items()} == {
        "process_scan": None, "imu_chain": "process_scan",
        "odom_step": "process_scan", "preprocess": "odom_step",
        "scan_to_map": "odom_step", "kf_map_insert": "odom_step"}
    roots = [e for e in _stage_events(prof) if e.name == "stage:process_scan"]
    assert [e.kwinputs for e in roots] == [{"scan": i} for i in range(3)]
    assert profiling.counters()["scans"] == 3


def test_batched_replay_counts_lanes(scans):
    cfg = SlamConfig().replace(sensor=SensorConfig(
        n_scan=16, horizon_scan=H, max_raw_points=16 * H))
    lanes = [[pts for pts, _lab in scans[0][:2]],
             [pts for pts, _lab in scans[0][1:3]]]
    with _profile() as prof:
        poses = batched.replay_batched(lanes, cfg, device="cpu")
    assert poses.shape == (2, 2, 6)
    assert profiling.counters("replay_batched")["scans"] == 4
    names = [e.name for e in _stage_events(prof)]
    assert names.count("stage:lane_upload") == 2
    assert names.count("stage:lane_step") == 2
    assert names.count("stage:gather") == 1


def test_sync_warnings_count_in_the_innermost_stage():
    timer = profiling.StageTimer()
    before = (warnings.showwarning, list(warnings.filters))
    with _profile(), warnings.catch_warnings(record=True) as shown:
        with profiling.root(timer, "process_scan", scan=0):
            for _ in range(3):  # one call site, every occurrence
                warnings.warn(SYNC)
            with profiling.span("scan_to_map"):
                for _ in range(5):
                    warnings.warn(f"{SYNC} (Triggered internally at x.cpp)")
            warnings.warn("something else", RuntimeWarning)
    assert (warnings.showwarning, warnings.filters) == before
    assert profiling.counters("process_scan")["host_syncs"] == 3
    assert profiling.counters("scan_to_map")["host_syncs"] == 5
    assert profiling.counters()["host_syncs"] == 8
    assert [str(w.message) for w in shown] == ["something else"]


def _span_sites():
    """(file, name) of every literal stage name in the port's calls of
    profiling.span / root and StageTimer.stage."""
    out = []
    for f in sorted(PKG.rglob("*.py")):
        for node in ast.walk(ast.parse(f.read_text())):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)):
                continue
            arg = {"span": 0, "stage": 0, "root": 1}.get(node.func.attr)
            if (arg is not None and len(node.args) > arg
                    and isinstance(node.args[arg], ast.Constant)):
                out.append((f.name, node.args[arg].value))
    return out


def test_every_range_is_a_stage_range(scans, monkeypatch):
    """Ranges open only through the profiling module, all named
    `stage:<name>`; the names are plain, and those of the fused step are
    all there."""
    named = []
    fast = profiling._RecordFunctionFast

    def spy(name, *a):
        named.append(name)
        return fast(name, *a)

    monkeypatch.setattr(profiling, "_RecordFunctionFast", spy)
    cfg = _micro_cfg()
    system = slam.SemanticSlam(cfg, device="cpu")
    with _profile():
        for i, (pts, lab) in enumerate(scans[0][:2]):
            system.process_scan(driver.pad_scan(pts, cfg), gt_labels=lab,
                                timestamp=0.1 * i)
    assert named and all(n.startswith("stage:") for n in named)
    sites = _span_sites()
    assert {n for _f, n in sites} >= {
        "process_scan", "finish", "odom_step", "imu_chain", "preprocess",
        "scan_to_map", "kf_map_insert", "kf_semantic", "rangenet",
        "semantic_refine", "descriptors", "replay_batched", "lane_upload",
        "lane_step", "gather", "drain"}
    assert all(n.isidentifier() for _f, n in sites), sites
    for f in PKG.rglob("*.py"):
        if f.name != "profiling.py":
            text = f.read_text()
            assert "record_function" not in text, f
            assert "_RecordFunctionFast" not in text, f
