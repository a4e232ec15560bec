"""Device time by the stage that launched it (harness/trace.py
`stage_device_seconds`) on synthetic events, and its reader
preprocess_device_ms. Times in ns; a launch call and its device
operations share a correlation id."""

import pytest

from perfbench.harness.spec import metric_reader
from perfbench.harness.trace import (UNATTRIBUTED, TraceSummary,
                                     stage_device_seconds)
from perfbench.harness.window import RunRecord

MS = 1_000_000


def _events():
    host = [
        ("stage:process_scan", 0, 100 * MS, 0, "host"),
        ("stage:preprocess", 10 * MS, 20 * MS, 0, "host"),
        ("stage:scan_to_map", 30 * MS, 60 * MS, 0, "host"),
        ("stage:process_scan", 200 * MS, 300 * MS, 0, "host"),
        ("stage:preprocess", 210 * MS, 220 * MS, 0, "host"),
        # launch calls
        ("cudaGraphLaunch", 12 * MS, 13 * MS, 1, "host"),
        ("cudaLaunchKernel", 25 * MS, 26 * MS, 2, "host"),
        ("cudaLaunchKernel", 40 * MS, 41 * MS, 3, "host"),
        ("cudaLaunchKernel", 150 * MS, 151 * MS, 4, "host"),
        ("cudaGraphLaunch", 211 * MS, 212 * MS, 5, "host"),
        ("cudaMemcpyAsync", 20 * MS, 21 * MS, 8, "host"),
    ]
    device = [
        # a graph replay: three kernels, one correlation id; the last runs
        # past the end of the stage that launched it
        ("graph_kernel_a", 13 * MS, 14 * MS, 1, "device"),
        ("graph_kernel_b", 14 * MS, 16 * MS, 1, "device"),
        ("graph_kernel_c", 16 * MS, 35 * MS, 1, "device"),
        # launched in process_scan between its children
        ("fill_kernel", 26 * MS, 27 * MS, 2, "device"),
        ("knn_tiles_kernel", 41 * MS, 45 * MS, 3, "device"),
        # launched outside every stage
        ("upload_kernel", 152 * MS, 153 * MS, 4, "device"),
        ("graph_kernel_a", 212 * MS, 213 * MS, 5, "device"),
        # launched at a stage's end: outside it
        ("Memcpy HtoD", 21 * MS, 22 * MS, 8, "device"),
        # its launch is not in the trace
        ("orphan_kernel", 230 * MS, 231 * MS, 9, "device"),
    ]
    return host + device


def test_each_operation_goes_to_the_stage_that_launched_it():
    by_stage, by_name = stage_device_seconds(_events(), 0, 400 * MS)
    assert by_stage["preprocess"] == pytest.approx(0.023)  # 1 + 2 + 19 + 1
    assert by_stage["scan_to_map"] == pytest.approx(0.004)
    assert by_stage["process_scan"] == pytest.approx(0.002)  # fill, memcpy
    assert by_stage[UNATTRIBUTED] == pytest.approx(0.002)  # upload, orphan
    assert set(by_stage) == {"preprocess", "scan_to_map", "process_scan",
                             UNATTRIBUTED}
    assert by_name["graph_kernel_a"] == pytest.approx(0.002)
    assert by_name["graph_kernel_c"] == pytest.approx(0.019)
    assert sum(by_stage.values()) == pytest.approx(sum(by_name.values()),
                                                   abs=1e-12)


def test_the_window_clips_and_the_sums_agree():
    lo, hi = 15 * MS, 212_500_000
    by_stage, by_name = stage_device_seconds(_events(), lo, hi)
    want = 0.001 + 0.019 + 0.001 + 0.004 + 0.001 + 0.0005 + 0.001
    assert sum(by_name.values()) == pytest.approx(want)
    assert sum(by_stage.values()) == pytest.approx(want, abs=1e-12)
    assert "graph_kernel_a" in by_name  # the second replay's half
    assert by_stage["preprocess"] == pytest.approx(0.001 + 0.019 + 0.0005)


def test_nested_ranges_of_one_start_take_the_inner():
    events = [("stage:outer", 0, 10, 0, "host"),
              ("stage:inner", 0, 5, 0, "host"),
              ("cudaLaunchKernel", 0, 1, 7, "host"),
              ("cudaLaunchKernel", 6, 7, 8, "host"),
              ("k", 1, 3, 7, "device"), ("k", 7, 9, 8, "device")]
    by_stage, _ = stage_device_seconds(events, 0, 10)
    assert by_stage == {"inner": 2e-9, "outer": 2e-9}


def _run(stage_s, scans=4):
    rec = RunRecord()
    rec.trace_scans = scans
    rec.trace = TraceSummary(window_s=1.0, busy_s=0.1, launches=10,
                             device_ops=[], idle_gaps=[],
                             stage_device_s=stage_s)
    return rec


def test_preprocess_device_ms():
    read = metric_reader("preprocess_device_ms")
    assert read(_run({"preprocess": 0.006, UNATTRIBUTED: 1.0})) == \
        pytest.approx(1.5)
    # a program without the span, an untraced run, no scans
    assert read(_run({"lane_step": 0.5})) is None
    assert read(RunRecord()) is None
    assert read(_run({"preprocess": 0.006}, scans=0)) is None
