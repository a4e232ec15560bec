"""The front end's preprocessing replayed from CUDA graphs
(utils/graphs.py through `odometry.preprocess`), on the card. Every test
here is marked `cuda` and skips without a GPU; the file imports no JAX:

    python -m pytest tests/test_torch_graphs_cuda.py -m cuda --noconftest

The replays are held to the eager chain (the same `preprocess` with the
graphs switched off) bit for bit, every output tensor, over consecutive
scans at full width: the HDL-64 kitti config with one scan, with 8
lanes and with the greedy feature selection, and the VLP-16 lio config
with its IMU window (graph of the pretreatment, the deskew eager, graph
of the rest). A call's results stay
as they were after the next call replays, and share no memory with the
graphs' buffers; a second padded shape captures a graph of its own.
"""

import dataclasses

import numpy as np
import pytest
import torch

from lis_slam_torch.config import kitti_config, lio_config
from lis_slam_torch.io import synthetic_torch
from lis_slam_torch.parallel import batched
from lis_slam_torch.pipeline import driver, odometry
from lis_slam_torch.utils import graphs, profiling

pytestmark = pytest.mark.cuda

VLP16 = np.linspace(15.0, -15.0, 16)
N_SCANS = 4  # the first captures; three replays after it


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs run only on the card")
    graphs.clear()
    profiling.reset_counters()
    yield torch.device("cuda", 0)
    graphs.clear()
    profiling.reset_counters()


def _eager(scan, cfg, monkeypatch):
    with monkeypatch.context() as m:
        m.setattr(graphs, "_on_card", lambda inputs: False)
        return odometry.preprocess(scan, cfg, return_ext=True)


def _scans(case, dev):
    """(cfg, N_SCANS ScanInputs on the card)."""
    if case == "lio":
        cfg = lio_config()
        raw, gt = synthetic_torch.render_sequence_device(
            N_SCANS, seed=5, device=dev, distorted=True, n_scan=16,
            elevations=VLP16)
        scans = []
        for i, (p, _lab, v) in enumerate(raw):
            g, _a, t = synthetic_torch.imu_rows(gt[i], gt[i + 1])
            sin = driver.pad_scan(p[v].cpu().numpy(), cfg, dev,
                                  imu_time=t + 0.1 * i, imu_gyro=g,
                                  scan_start=0.1 * i)
            scans.append(sin._replace(deskew_vel=torch.tensor(
                [8.0, 0.4, 0.0], device=dev)))
        return cfg, scans
    cfg = kitti_config()
    if case == "kitti_greedy":
        cfg = cfg.replace(feature=dataclasses.replace(
            cfg.feature, greedy_selection=True))
    lanes = 8 if case == "kitti_lanes8" else 1
    raw, _gt = synthetic_torch.render_sequence_device(
        N_SCANS + lanes - 1, seed=5, device=dev)
    one = [driver.pad_scan(p[v].cpu().numpy(), cfg, dev)
           for p, _lab, v in raw]
    if lanes == 1:
        return cfg, one
    return cfg, [batched.stack_scans(one[i:i + lanes])
                 for i in range(N_SCANS)]


@pytest.mark.parametrize("case", ["kitti_one", "kitti_lanes8", "lio",
                                  "kitti_greedy"])
def test_replays_are_the_eager_chain(dev, case, monkeypatch):
    cfg, scans = _scans(case, dev)
    wants = [_eager(s, cfg, monkeypatch) for s in scans]
    outs = []
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        for i, s in enumerate(scans):
            # the capture synchronizes; a replay never waits on the card
            torch.cuda.set_sync_debug_mode("error" if i else "default")
            try:
                outs.append(odometry.preprocess(s, cfg, return_ext=True))
            finally:
                torch.cuda.set_sync_debug_mode("default")
    counts = profiling.counters()
    assert (counts["preprocess_eager"], counts["preprocess_replays"]) == \
        (1, N_SCANS - 1)
    assert len(graphs._graphs) == (2 if case == "lio" else 1)
    # every call's results, after all the later replays
    for out, want in zip(outs, wants):
        for tree_g, tree_w in zip(out, want):
            for name, g, w in zip(tree_w._fields, tree_g, tree_w):
                assert g.dtype == w.dtype and torch.equal(g, w), name
                assert g.stride() == w.stride(), name
    static = {t.untyped_storage().data_ptr()
              for cap in graphs._graphs.values()
              for t in graphs._leaves(cap.outputs) + list(cap.inputs)}
    for out in outs:
        assert not static & {t.untyped_storage().data_ptr()
                             for t in graphs._leaves(out)}
    fc = outs[-1][0]
    assert int(fc.surf_mask.sum()) > 1000 and int(fc.corner_mask.sum()) > 50


def test_a_second_shape_captures_its_own_graph(dev, monkeypatch):
    cfg, scans = _scans("kitti_one", dev)
    wide = cfg.replace(sensor=dataclasses.replace(
        cfg.sensor, max_raw_points=cfg.sensor.max_raw_points + 4096))
    wide_scans = [driver.pad_scan(s.points[s.valid].cpu().numpy(), wide, dev)
                  for s in scans]
    for i in range(N_SCANS):  # the two shapes in turns, one config
        for s in (scans[i], wide_scans[i]):
            out = odometry.preprocess(s, cfg, return_ext=True)
            want = _eager(s, cfg, monkeypatch)
            assert all(torch.equal(g, w) for g, w in
                       zip(graphs._leaves(out), graphs._leaves(want)))
        assert len(graphs._graphs) == 2
    shapes = sorted(sig[1][0][0] for sig in graphs._graphs)
    assert shapes == [(cfg.sensor.max_raw_points, 4),
                      (wide.sensor.max_raw_points, 4)]
