"""The front end's preprocessing through utils/graphs.py, on the CPU.

- `odometry.preprocess` against the chain as it was composed before the
  graphs (pretreat, deskew, project_and_extract, extract_features), bit
  for bit, for one scan, for lanes, with the gyro deskew of an IMU window
  and with the velocity deskew; while a profiler records, each call counts
  `preprocess_eager` (the CPU never replays).
- The replay mechanism with the CUDA graph stood in for by a re-run of
  the chain into the captured outputs (`_FakeGraph`), so that the cache,
  the copies in and the fresh results run here: one capture a signature
  (shapes, devices, the sensor and feature configs), results equal to the
  eager chain's and laid out alike, none aliasing the graph's buffers,
  and a call's results unchanged by the next replay. The real capture and
  replay are held to the same on the card (test_torch_graphs_cuda.py).

The scans are 16 x 360 beams of the synthetic city.
"""

import dataclasses

import numpy as np
import pytest
import torch

from lis_slam_torch.config import SlamConfig, lio_config
from lis_slam_torch.io import synthetic_torch
from lis_slam_torch.ops import deskew, features as feat_ops
from lis_slam_torch.ops import pretreatment, projection, velocity_deskew
from lis_slam_torch.parallel import batched
from lis_slam_torch.pipeline import driver, odometry
from lis_slam_torch.utils import graphs, profiling

VLP16 = np.linspace(15.0, -15.0, 16)
H = 360


def _cfg(base=None, points=16 * H):
    base = base or SlamConfig()
    return base.replace(
        sensor=dataclasses.replace(
            base.sensor, n_scan=16, horizon_scan=H, downsample_rate=1,
            lidar_min_range=1.0, lidar_max_range=80.0,
            max_raw_points=points),
        feature=dataclasses.replace(
            base.feature, max_corner_points=512, max_surf_points=2048,
            max_sharp_corner_points=256, max_sharp_surf_points=512))


@pytest.fixture(scope="module")
def sweeps():
    """Three distorted 16-beam sweeps: (host clouds, true poses)."""
    raw, gt = synthetic_torch.render_sequence_device(
        3, seed=5, distorted=True, n_scan=16, horizon=H, elevations=VLP16)
    return [p[v].numpy() for p, _lab, v in raw], gt


@pytest.fixture(autouse=True)
def _fresh_state():
    graphs.clear()
    profiling.reset_counters()
    yield
    graphs.clear()
    profiling.reset_counters()


def _scans(case, sweeps, cfg):
    """The case's ScanInputs, one a sweep."""
    clouds, gt = sweeps
    if case == "lanes":
        scans = [driver.pad_scan(c, cfg) for c in clouds]
        return [batched.stack_scans([scans[i], scans[(i + 1) % 3],
                                     scans[(i + 2) % 3]]) for i in range(3)]
    out = []
    for i, c in enumerate(clouds):
        if case == "imu":
            g, _a, t = synthetic_torch.imu_rows(gt[i], gt[i + 1])
            sin = driver.pad_scan(c, cfg, imu_time=t + 0.1 * i, imu_gyro=g,
                                  scan_start=0.1 * i)
            sin = sin._replace(deskew_vel=torch.tensor([8.0, 0.5, 0.0]))
        elif case == "velocity":
            sin = driver.pad_scan(c, cfg, velocity=np.array([8.0, 0.5, 0.0]),
                                  angular_rate=np.array([0.0, 0.0, 0.13]))
        else:
            sin = driver.pad_scan(c, cfg)
        out.append(sin)
    return out


def _case_cfg(case):
    if case == "imu":
        return _cfg(lio_config())
    if case == "velocity":
        base = SlamConfig()
        return _cfg(base.replace(imu=dataclasses.replace(
            base.imu, deskew_mode="velocity")))
    cfg = _cfg()
    if case == "greedy":
        cfg = cfg.replace(feature=dataclasses.replace(
            cfg.feature, greedy_selection=True))
    return cfg


def _chain(scan, cfg):
    """The preprocessing composed op by op, as it was before the graphs."""
    pre = pretreatment.pretreat(scan.points, scan.valid, cfg.sensor)
    pts = pre.points[..., :3]
    if cfg.imu.deskew_mode == "velocity":
        if isinstance(scan.vel_valid, torch.Tensor):
            pts = velocity_deskew.velocity_deskew(
                pts, pre.rel_time, scan.ang_rate.to(pts), scan.vel.to(pts),
                pre.valid & scan.vel_valid[..., None])
        elif scan.vel_valid:
            pts = velocity_deskew.velocity_deskew(
                pts, pre.rel_time, scan.ang_rate.to(pts), scan.vel.to(pts),
                pre.valid)
    elif cfg.imu.use_imu and scan.imu_time is not None:
        info = deskew.integrate_gyro(scan.imu_time, scan.imu_gyro,
                                     scan.imu_valid, scan.scan_start)
        vel = None if scan.deskew_vel is None else scan.deskew_vel.to(pts)
        pts = deskew.deskew_points(pts, pre.rel_time, info, pre.valid,
                                   vel_body=vel)
    _img, ext = projection.project_and_extract(
        pts, pre.points[..., 3], pre.ring, pre.rel_time, pre.valid,
        cfg.sensor)
    return feat_ops.extract_features(
        ext, cfg.feature, greedy=cfg.feature.greedy_selection), ext


def _assert_same(got, want, layout=False):
    for tree_g, tree_w in zip(got, want):
        assert type(tree_g) is type(tree_w)
        for name, g, w in zip(tree_w._fields, tree_g, tree_w):
            assert g.dtype == w.dtype and torch.equal(g, w), name
            if layout:
                assert (g.stride(), g.storage_offset()) == \
                    (w.stride(), w.storage_offset()), name


def _profiled():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


CASES = ("one", "lanes", "imu", "velocity", "greedy")


@pytest.mark.parametrize("case", CASES)
def test_preprocess_is_the_chain_on_the_cpu(sweeps, case):
    cfg = _case_cfg(case)
    scans = _scans(case, sweeps, cfg)
    with _profiled():
        got = [odometry.preprocess(s, cfg, return_ext=True) for s in scans]
    for s, g in zip(scans, got):
        _assert_same(g, _chain(s, cfg))
    assert profiling.counters()["preprocess_eager"] == len(scans)
    assert profiling.counters()["preprocess_replays"] == 0
    assert not graphs._graphs  # the CPU captures nothing
    assert int(got[0][0].surf_mask.sum()) > 100


class _FakeGraph:
    """A CUDA graph's stand-in: `launch` runs the chain on the captured
    inputs and writes its results into the captured outputs."""

    captures = 0

    def __init__(self, fn, inputs):
        type(self).captures += 1
        self.fn = fn
        self.inputs = tuple(t.clone().contiguous() for t in inputs)
        self.outputs = fn(*self.inputs)

    def launch(self):
        fresh = self.fn(*self.inputs)
        for dst, src in zip(graphs._leaves(self.outputs),
                            graphs._leaves(fresh)):
            dst.copy_(src)


@pytest.fixture
def fake_card(monkeypatch):
    """graphs.replay as on the card, with _FakeGraph for the graph."""
    _FakeGraph.captures = 0

    def capture(fn, inputs):
        g = _FakeGraph(fn, inputs)
        return g.launch, g.inputs, g.outputs

    monkeypatch.setattr(graphs, "_on_card", lambda inputs: True)
    monkeypatch.setattr(graphs, "_capture", capture)
    return _FakeGraph


@pytest.mark.parametrize("case", CASES)
def test_replays_give_the_chain_on_memory_of_their_own(sweeps, case,
                                                       fake_card):
    cfg = _case_cfg(case)
    scans = _scans(case, sweeps, cfg)
    segments = 2 if case in ("imu", "velocity") else 1
    kept = []
    with _profiled():
        for s in scans + scans[:1]:
            out = odometry.preprocess(s, cfg, return_ext=True)
            # eager at the first call, which captures; replays after
            _assert_same(out, _chain(s, cfg), layout=True)
            kept.append((out, [t.clone() for t in graphs._leaves(out)]))
            assert fake_card.captures == segments
    counts = profiling.counters()
    assert (counts["preprocess_eager"], counts["preprocess_replays"]) == \
        (1, len(scans))
    static = {t.untyped_storage().data_ptr()
              for cap in graphs._graphs.values()
              for t in graphs._leaves(cap.outputs) + list(cap.inputs)}
    for out, copy in kept:  # every call's results, after all the replays
        assert all(torch.equal(t, c)
                   for t, c in zip(graphs._leaves(out), copy))
        assert not static & {t.untyped_storage().data_ptr()
                             for t in graphs._leaves(out)}
    # results that share a storage in the chain share one copy of it
    ext = kept[-1][0][1]
    assert ext.xyz.untyped_storage().data_ptr() == \
        ext.intensity.untyped_storage().data_ptr()


def test_each_signature_captures_its_own_graph(sweeps, fake_card):
    cfg = _cfg()
    scan = _scans("one", sweeps, cfg)[0]
    wider = _cfg(points=16 * H + 512)
    variants = [
        (cfg, scan),
        (wider, driver.pad_scan(sweeps[0][0], wider)),  # another shape
        (cfg.replace(sensor=dataclasses.replace(cfg.sensor,
                                                lidar_max_range=60.0)),
         scan),
        (cfg.replace(feature=dataclasses.replace(cfg.feature,
                                                 edge_threshold=0.5)),
         scan),
    ]
    for k, (c, s) in enumerate(variants):
        for _ in range(2):
            _assert_same(odometry.preprocess(s, c, return_ext=True),
                         _chain(s, c))
        assert fake_card.captures == k + 1
    # a config the chain does not read shares the graph
    other = cfg.replace(matching=dataclasses.replace(
        cfg.matching, max_iterations_frontend=3))
    odometry.preprocess(scan, other)
    assert fake_card.captures == len(variants)


def test_signature_separates_shapes_dtypes_devices_and_keys():
    cfg = _cfg()
    pts = torch.zeros(10, 4)
    valid = torch.zeros(10, dtype=torch.bool)
    key = (cfg.sensor, cfg.feature)
    base = graphs.signature("preprocess", (pts, valid), key)
    assert base == graphs.signature(
        "preprocess", (torch.ones(10, 4), valid),
        (_cfg().sensor, _cfg().feature))
    others = [
        graphs.signature("pretreat", (pts, valid), key),
        graphs.signature("preprocess", (torch.zeros(11, 4), valid), key),
        graphs.signature("preprocess", (pts.double(), valid), key),
        graphs.signature("preprocess", (pts.to("meta"), valid), key),
        graphs.signature("preprocess", (pts, valid), (
            dataclasses.replace(cfg.sensor, n_scan=32), cfg.feature)),
        graphs.signature("preprocess", (pts, valid), (
            cfg.sensor, dataclasses.replace(cfg.feature,
                                            greedy_selection=True))),
    ]
    assert len({base, *others}) == len(others) + 1
