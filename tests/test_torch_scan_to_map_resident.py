"""scan_to_map's loop with the solver state on the card
(ops/scan_match._scan_to_map_on_device: K2 over one lane, K3, one
read-back an iteration), run here on CPU tensors through the plain
versions of its kernels (gn_cuda.gn_iteration_lanes in float32,
gn_solve.solve_plain), against the host loop on the same problems: the
same iterations and searches, the same flags and counts, poses within
1e-4 m and 1e-5 rad. The dispatch takes the device loop only for CUDA
clouds under "pallas"; tests/test_torch_kernels_cuda.py holds it there
against this host loop. This file imports no JAX: the card test builds
its problem from here."""

import dataclasses

import numpy as np
import pytest
import torch

from lis_slam_torch.config import SlamConfig
from lis_slam_torch.ops import knn_cuda, scan_match
from lis_slam_torch.utils import profiling, se3

POSE_TRUE = (0.01, -0.02, 0.08, 0.5, -0.3, 0.05)
NEAR = (0.004, 0.003, -0.01, 0.1, -0.06, 0.02)  # guess - truth
FAR = (0.02, -0.015, 0.04, 0.35, -0.25, 0.08)


def _line_world(rng, n_lines=24, pts_per=24):
    """Vertical poles (corner map), dense enough along z that a query's
    5th neighbour lies inside the 1 m^2 gate."""
    pts = []
    for _ in range(n_lines):
        x, y = rng.uniform(-20, 20, 2)
        z = np.linspace(0, 4, pts_per)
        p = np.stack([np.full(pts_per, x), np.full(pts_per, y), z], 1)
        pts.append(p + rng.normal(0, 0.01, p.shape))
    return np.concatenate(pts).astype(np.float32)


def _plane_world(rng, n=3000):
    """Ground and two walls (surf map)."""
    g = np.stack([rng.uniform(-25, 25, n), rng.uniform(-25, 25, n),
                  np.zeros(n)], 1)
    w1 = np.stack([rng.uniform(-25, 25, n // 2),
                   np.full(n // 2, 10.0), rng.uniform(0, 6, n // 2)], 1)
    w2 = np.stack([np.full(n // 2, -12.0),
                   rng.uniform(-25, 25, n // 2), rng.uniform(0, 6, n // 2)], 1)
    pts = np.concatenate([g, w1, w2]).astype(np.float32)
    return pts + rng.normal(0, 0.005, pts.shape).astype(np.float32)


def problem(dev, offset=NEAR, seed=7, n_valid=None, weighted=False):
    """scan_to_map's positional arguments up to the map masks, on `dev`:
    map points seen from POSE_TRUE in the sensor frame, the guess
    POSE_TRUE + offset. `n_valid`: only that many query points masked in;
    `weighted`: per-point semantic weights (returned as a dict of
    keyword arguments)."""
    rng = np.random.default_rng(seed)
    corner_map, surf_map = _line_world(rng), _plane_world(rng)
    T_inv = se3.transform_inverse(se3.pose_to_matrix(
        torch.tensor(POSE_TRUE, dtype=torch.float32)))

    def sensor_cloud(world, n):
        sel = torch.from_numpy(world[rng.integers(0, len(world), n)])
        return se3.transform_points(T_inv, sel).to(dev)

    c_pts, s_pts = sensor_cloud(corner_map, 256), sensor_cloud(surf_map, 512)
    c_mask = torch.ones(256, dtype=torch.bool, device=dev)
    s_mask = torch.ones(512, dtype=torch.bool, device=dev)
    if n_valid is not None:
        c_mask[:] = False
        s_mask[n_valid:] = False
    guess = torch.tensor(POSE_TRUE, dtype=torch.float32) + torch.tensor(
        offset, dtype=torch.float32)
    args = (guess.to(dev), c_pts, c_mask, s_pts, s_mask,
            torch.from_numpy(corner_map).to(dev),
            torch.ones(len(corner_map), dtype=torch.bool, device=dev),
            torch.from_numpy(surf_map).to(dev),
            torch.ones(len(surf_map), dtype=torch.bool, device=dev))
    kw = {}
    if weighted:
        kw = {"corner_sem_weight": torch.from_numpy(
                  rng.uniform(0.5, 1.5, 256).astype(np.float32)).to(dev),
              "surf_sem_weight": torch.from_numpy(
                  rng.uniform(0.5, 1.5, 512).astype(np.float32)).to(dev)}
    return args, kw


def matching(**kw):
    return dataclasses.replace(SlamConfig().matching, gn_backend="pallas",
                               **kw)


def assert_same_solve(got, want, n_valid_rtol=0.0):
    """The device loop's GNState against the host loop's: the same
    iterations and flags, n_valid within `n_valid_rtol`, poses within
    1e-5 rad and 1e-4 m, the last step's deltas within 1e-4 (deg, cm:
    2% of the convergence thresholds). On the card K2 sums in float64,
    which moves the last step by up to ~5e-5 cm against the float32 host
    loop here."""
    assert (got.it, got.converged, got.degenerate) == \
        (want.it, want.converged, want.degenerate)
    assert abs(got.n_valid - want.n_valid) <= n_valid_rtol * want.n_valid
    d = (got.pose.cpu() - want.pose.cpu()).abs()
    assert float(d[:3].max()) <= 1e-5, d
    assert float(d[3:].max()) <= 1e-4, d
    assert got.delta_r == pytest.approx(want.delta_r, rel=1e-3, abs=1e-4)
    assert got.delta_t == pytest.approx(want.delta_t, rel=1e-3, abs=1e-4)


def _searching(monkeypatch) -> list:
    """Count knn_cuda.knn calls: two a search (corner, surf)."""
    calls = []
    knn = knn_cuda.knn

    def counted(*a, **kw):
        calls.append(1)
        return knn(*a, **kw)

    monkeypatch.setattr(knn_cuda, "knn", counted)
    return calls


CASES = {
    # converges inside the cache, no refresh
    "near": (dict(), dict(), 15),
    # the guess 0.44 m off: the drift test refreshes the cache
    "refresh": (dict(offset=FAR), dict(), 15),
    # stops at max_iterations before converging
    "max_iterations": (dict(offset=FAR), dict(), 2),
    # n_valid < min_valid_points: a zero step, converged at once
    "few_valid": (dict(n_valid=30), dict(), 15),
    # semantic weights, as semantic_refine and the submap registration
    "weighted": (dict(offset=FAR, weighted=True),
                 dict(nn_cache_refresh_dist=0.1), 20),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_device_loop_is_the_host_loop(case, monkeypatch):
    make, cfg_kw, max_it = CASES[case]
    args, kw = problem(torch.device("cpu"), **make)
    cfg = matching(**cfg_kw)
    calls = _searching(monkeypatch)
    want = scan_match.scan_to_map(*args, cfg, max_it, **kw)
    host_searches = len(calls) // 2
    calls.clear()
    monkeypatch.setattr(scan_match, "_gn_on_device",
                        lambda dev, c: c.gn_backend == "pallas")
    got = scan_match.scan_to_map(*args, cfg, max_it, **kw)
    assert len(calls) // 2 == host_searches
    assert_same_solve(got, want)
    assert got.pose.device == args[0].device and got.proj.shape == (6, 6)
    if case == "refresh" or case == "weighted":
        assert host_searches >= 2
    if case == "max_iterations":
        assert got.it == max_it and not got.converged
    if case == "few_valid":
        assert got.n_valid < cfg.min_valid_points and got.it == 1
        assert torch.equal(got.pose, args[0])
    if case in ("near", "refresh"):
        assert got.converged and got.it < max_it


def test_device_loop_counts_its_solves(monkeypatch):
    """Under a profiler each device-loop iteration adds one to
    gn_iterations and one to gn_device_solves; the host loop adds none to
    the second."""
    args, _kw = problem(torch.device("cpu"), offset=FAR)
    cfg = matching()
    profiling.reset_counters()
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            host = scan_match.scan_to_map(*args, cfg, 15)
            monkeypatch.setattr(scan_match, "_gn_on_device",
                                lambda dev, c: True)
            dev = scan_match.scan_to_map(*args, cfg, 15)
        c = profiling.counters()
    finally:
        profiling.reset_counters()
    assert c["gn_iterations"] == host.it + dev.it
    assert c["gn_device_solves"] == dev.it > 0


def test_device_loop_only_for_cuda_under_pallas():
    cuda, cpu = torch.device("cuda", 0), torch.device("cpu")
    assert scan_match._gn_on_device(cuda, matching())
    assert not scan_match._gn_on_device(cpu, matching())
    assert not scan_match._gn_on_device(
        cuda, dataclasses.replace(matching(), gn_backend="xla"))


def test_read_back_round_trips_the_state():
    """The packed row holds each field of the two one-lane states."""
    from lis_slam_torch.ops import gn_solve

    before = gn_solve.init_state(torch.arange(6.0)[None])
    after = before._replace(
        pose=torch.arange(6.0)[None] * -0.5,
        n_valid=torch.tensor([1234], dtype=torch.int32),
        it=torch.tensor([3], dtype=torch.int32),
        delta_r=torch.tensor([0.25]), delta_t=torch.tensor([1.5]),
        degenerate=torch.tensor([True]), converged=torch.tensor([False]))
    got = scan_match._read_back(
        before, after, torch.empty(scan_match._READBACK.size,
                                   dtype=torch.uint8))
    assert got[:6] == tuple(float(v) for v in range(6))
    assert got[6:12] == tuple(-0.5 * v for v in range(6))
    assert got[12:] == (1234, 3, 0.25, 1.5, True, False)
