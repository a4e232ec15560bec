"""The reader of preprocess_replay_share: lis_slam_torch's counters
`preprocess_replays` over `preprocess_replays` + `preprocess_eager` of the
profiled session, null where the program has no such counters or where
they counted no call."""

import pytest
import torch

from lis_slam_torch.utils import profiling
from perfbench.harness.spec import metric_reader
from perfbench.harness.window import RunRecord

READ = metric_reader("preprocess_replay_share")


@pytest.fixture
def counted():
    """A profiled session of 4 scans: 3 preprocessing calls replayed, one
    run eagerly."""
    profiling.reset_counters()
    timer = profiling.StageTimer()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        for i in range(4):
            with profiling.root(timer, "process_scan", scan=i):
                profiling.count("scans")
                with profiling.span("preprocess"):
                    profiling.count("preprocess_replays" if i
                                    else "preprocess_eager")
    yield
    profiling.reset_counters()


def _run(trace_scans):
    rec = RunRecord()
    rec.trace_scans = trace_scans
    return rec


def test_share_of_the_counted_calls(counted):
    assert READ(_run(4)) == pytest.approx(0.75)


def test_null_where_nothing_was_counted():
    profiling.reset_counters()
    assert READ(_run(0)) is None


def test_null_without_the_counters(counted, monkeypatch):
    """The parent of this metric's program counts neither."""
    monkeypatch.setattr(profiling, "counters",
                        lambda stage=None: {"scans": 4, "host_syncs": 0})
    assert READ(_run(4)) is None
    monkeypatch.delattr(profiling, "counters")
    assert READ(_run(4)) is None
