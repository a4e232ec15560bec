"""The readers of the program's own spans and counters: preprocess_ms,
scan_to_map_ms and kf_semantic_ms from the stage totals of the sessions
run without the profiler; host_syncs_per_scan and gn_iterations_per_scan
from lis_slam_torch's counters of the profiled session, null where the
program has none or where they did not count that session's scans."""

import pytest
import torch

from lis_slam_torch.utils import profiling
from perfbench.harness.spec import metric_reader
from perfbench.harness.window import RunRecord

SPANS = ("preprocess_ms", "scan_to_map_ms", "kf_semantic_ms")
COUNTS = ("host_syncs_per_scan", "gn_iterations_per_scan")


@pytest.fixture
def counted():
    """The counters of a profiled session of 4 scans: 10 syncs, 6 of them
    and 9 GN iterations in the front end's span, 2 GN iterations
    elsewhere."""
    profiling.reset_counters()
    timer = profiling.StageTimer()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        for i in range(4):
            with profiling.root(timer, "process_scan", scan=i):
                profiling.count("scans")
        with profiling.root(timer, "process_scan"):
            profiling.count("host_syncs", 4)
            with profiling.span("scan_to_map"):
                profiling.count("host_syncs", 6)
                profiling.count("gn_iterations", 9)
            with profiling.span("submap_register"):
                profiling.count("gn_iterations", 2)
    yield
    profiling.reset_counters()


def _run(**kw):
    rec = RunRecord()
    for k, v in kw.items():
        setattr(rec, k, v)
    return rec


@pytest.mark.parametrize("name", SPANS)
def test_span_readers(name):
    stage = name[:-3]
    rec = _run(stage_s={stage: [8, 0.2], "odom_step": [40, 2.0]},
               span_scans=40)
    assert metric_reader(name)(rec) == pytest.approx(5.0)
    # a program without the span (the parent of this change), or no scan
    assert metric_reader(name)(_run(stage_s={"odom_step": [40, 2.0]},
                                    span_scans=40)) is None
    assert metric_reader(name)(_run(stage_s={stage: [0, 0.0]},
                                    span_scans=0)) is None


def test_counter_readers(counted):
    rec = _run(trace_scans=4)
    assert metric_reader("host_syncs_per_scan")(rec) == pytest.approx(2.5)
    assert metric_reader("gn_iterations_per_scan")(rec) == \
        pytest.approx(2.25)


@pytest.mark.parametrize("name", COUNTS)
def test_counter_readers_null_on_other_scans(counted, name):
    assert metric_reader(name)(_run(trace_scans=5)) is None
    assert metric_reader(name)(_run(trace_scans=0)) is None


@pytest.mark.parametrize("name", COUNTS)
def test_counter_readers_null_without_counters(counted, name, monkeypatch):
    monkeypatch.delattr(profiling, "counters")
    assert metric_reader(name)(_run(trace_scans=4)) is None


def test_gn_reader_null_without_a_front_end():
    """The fleet's scheduled solve counts no iteration: null, not 0."""
    profiling.reset_counters()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiling.root(profiling.StageTimer(), "replay_batched"):
            profiling.count("scans", 8)
    try:
        rec = _run(trace_scans=8)
        assert metric_reader("gn_iterations_per_scan")(rec) is None
        assert metric_reader("host_syncs_per_scan")(rec) == 0.0
    finally:
        profiling.reset_counters()
