"""The arithmetic of the end-to-end metrics, the rooflines and the
per-layer readers, on synthetic timelines."""

import math

import numpy as np
import pytest
import torch

from perfbench.harness import bounds, stats
from perfbench.harness.trace import TraceSummary
from perfbench.harness.window import RunRecord
from perfbench.metrics import (device_idle, drain_ms, fused_step_ms,
                               imu_chain_ms, k1_roofline, k2_roofline,
                               launches_per_scan)


def _timeline(n=600, base=0.04, stall_every=12, stall=0.05, seed=0):
    rng = np.random.default_rng(seed)
    lat = base + rng.uniform(0, 0.004, n)
    lat[::stall_every] += stall
    return lat.tolist()


def test_percentile_matches_numpy_linear():
    lat = _timeline()
    for q in (50, 90, 95, 99):
        assert stats.percentile(lat, q) == pytest.approx(
            float(np.percentile(lat, q)), rel=1e-12)


def test_p95_lands_among_the_stalled_scans():
    # one scan in 12 (8.3%) carries the stall: the 95th percentile is a
    # stalled scan's latency, the median an ordinary one's
    lat = _timeline()
    assert stats.percentile(lat, 95) > 0.09
    assert stats.percentile(lat, 50) < 0.045


def test_percentile_of_one_and_of_none():
    assert stats.percentile([0.5], 95) == 0.5
    with pytest.raises(ValueError):
        stats.percentile([], 95)


def test_rate_counts_all_work_over_all_time():
    lat = _timeline()
    wall = sum(lat) + 1.5  # session starts and ends inside the window
    assert stats.rate(len(lat), wall) == len(lat) / wall
    with pytest.raises(ValueError):
        stats.rate(10, 0.0)


def test_busy_and_gaps_partition_the_window():
    iv = [(0, 2), (1, 3), (5, 6), (8, 12)]
    assert stats.busy_seconds(iv) == 8
    gaps = stats.idle_gaps(iv, 0, 10)
    assert gaps == [(3, 5), (6, 8)]
    assert stats.busy_seconds([(max(a, 0), min(b, 10)) for a, b in iv]) + \
        sum(b - a for a, b in gaps) == 10


def test_bound_takes_the_larger_of_bytes_and_operations():
    t = bounds.bound_s(3.35e12, 0.0)
    assert t == pytest.approx(1.0)
    t = bounds.bound_s(0.0, 67e12, 34e12)
    assert t == pytest.approx(2.0)


def test_k1_bound_counts_pairs_within_the_cap():
    q = torch.zeros(4, 3)
    ref = torch.tensor([[0.5, 0, 0], [1.5, 0, 0], [3.0, 0, 0], [0, 0, 0]])
    mask = torch.tensor([True, True, True, False])
    nbytes = 4 * 12 + 4 * 13 + 4 * 5 * 20
    # pairs within 4 m^2: 0.25 and 2.25 for each of the 4 queries
    want = max(nbytes / bounds.PEAK_BYTES_S, 8 * 8 / bounds.PEAK_FP32_FLOPS)
    assert bounds.k1_bound_s(q, ref, mask, 5, 4.0) == pytest.approx(want)
    want_u = max(nbytes / bounds.PEAK_BYTES_S,
                 8 * 12 / bounds.PEAK_FP32_FLOPS)
    assert bounds.k1_bound_s(q, ref, mask, 5, None) == pytest.approx(want_u)


def test_k2_bound_counts_masked_in_queries():
    pts = torch.zeros(10, 3)
    mask = torch.tensor([True] * 6 + [False] * 4)
    k = 8
    nbytes = 2 * 64 * 4 + 43 * 4 + 2 * 10 * (12 + 1 + 13 * k)
    flops = 2 * 6 * bounds.gn_flops(k)
    want = max(nbytes / bounds.PEAK_BYTES_S, flops / bounds.PEAK_FP32_FLOPS)
    got = bounds.k2_bound_s([(pts, mask, None), (pts, mask, None)], k)
    assert got == pytest.approx(want)


def _record():
    rec = RunRecord(scans=420, window_s=12.0, span_scans=280)
    rec.stage_s = {"odom_step": [280, 8.4], "drain": [24, 1.2]}
    rec.imu_s = 2.8
    rec.trace = TraceSummary(window_s=6.0, busy_s=0.6, launches=210000,
                             device_ops=[], idle_gaps=[],
                             kernel_s={"K1": 0.02, "K2": 0.01})
    rec.trace_scans = 140
    rec.kernel_bound_s = {"K1": 0.0002, "K2": 0.0005}
    return rec


def test_readers_of_a_record():
    rec = _record()
    assert fused_step_ms.read(rec) == pytest.approx(30.0)
    assert drain_ms.read(rec) == pytest.approx(50.0)
    assert imu_chain_ms.read(rec) == pytest.approx(10.0)
    assert launches_per_scan.read(rec) == pytest.approx(1500.0)
    assert device_idle.read(rec) == pytest.approx(90.0)
    assert k1_roofline.read(rec) == pytest.approx(1.0)
    assert k2_roofline.read(rec) == pytest.approx(5.0)


def test_readers_find_nothing_and_say_so():
    rec = RunRecord()
    for mod in (fused_step_ms, drain_ms, imu_chain_ms, launches_per_scan,
                device_idle, k1_roofline, k2_roofline):
        assert mod.read(rec) is None
    # a kernel whose launches the probes did not all see reads null
    rec = _record()
    rec.kernel_bound_s = {"K2": 0.0005}
    assert k1_roofline.read(rec) is None


def test_kernel_bounds_drops_a_kernel_with_unseen_launches():
    from perfbench.harness.window import kernel_bounds

    q = torch.zeros(2, 3)
    ref = torch.ones(4, 3)
    mask = torch.ones(4, dtype=torch.bool)
    log = [("K1", False, q, ref, mask, 5, 4.0)] * 3
    assert set(kernel_bounds(log, {"K1": 3})) == {"K1"}
    assert kernel_bounds(log, {"K1": 4}) == {}
    assert math.isfinite(kernel_bounds(log, {"K1": 3})["K1"])
