"""The reader of gn_device_solve_share: lis_slam_torch's counters
`gn_device_solves` over `gn_iterations` of the profiled session, null
where the program has no such counter or where no iteration ran."""

import pytest
import torch

from lis_slam_torch.utils import profiling
from perfbench.harness.spec import metric_reader
from perfbench.harness.window import RunRecord

READ = metric_reader("gn_device_solve_share")


@pytest.fixture
def counted():
    """A profiled session of 2 scans: 4 GN iterations solved on the card
    in the front end, 1 more outside it in the host loop."""
    profiling.reset_counters()
    timer = profiling.StageTimer()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        for i in range(2):
            with profiling.root(timer, "process_scan", scan=i):
                profiling.count("scans")
                with profiling.span("scan_to_map"):
                    profiling.count("gn_device_solves", 2)
                    profiling.count("gn_iterations", 2)
                profiling.count("gn_iterations", i)
    yield
    profiling.reset_counters()


def _run(trace_scans):
    rec = RunRecord()
    rec.trace_scans = trace_scans
    return rec


def test_share_of_the_counted_iterations(counted):
    assert READ(_run(2)) == pytest.approx(4 / 5)


def test_null_where_no_iteration_ran():
    profiling.reset_counters()
    assert READ(_run(0)) is None


def test_null_without_the_counter(counted, monkeypatch):
    """The parent of this metric's program counts iterations but no
    device solves."""
    monkeypatch.setattr(profiling, "counters",
                        lambda stage=None: {"scans": 2, "gn_iterations": 5})
    assert READ(_run(2)) is None
    monkeypatch.delattr(profiling, "counters")
    assert READ(_run(2)) is None
