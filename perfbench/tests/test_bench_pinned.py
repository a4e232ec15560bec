"""The tiny cells' numbers on a fixed seed, pinned to the values that the
harness gave on the CPU before checks, captures and per-stage device time
could be brought as files: the `checked` numbers of a whole run, and the
counter readers over a profiled session. A change to the harness that
alters what an existing cell checks or reads shows here as a changed
value; the numbers are compared bit for bit."""

import json

import pytest
import torch

from perfbench import run
from perfbench.harness import program, traffic
from perfbench.harness import probes as P
from perfbench.harness.spec import metric_reader
from perfbench.harness.window import RunRecord
from perfbench.tests import test_bench_correct, test_bench_fleet
from perfbench.tests import test_bench_lio

CELLS = {
    "tiny": (test_bench_correct._cell, 4294967311),
    "tiny_lio": (test_bench_lio._cell, test_bench_lio.SEED),
    "tiny_fleet": (test_bench_fleet._cell, 99),
}
COUNTERS = ("gn_iterations_per_scan", "host_syncs_per_scan",
            "preprocess_replay_share")

PINNED = {
    "tiny": {
        "checked": {"attempted": 8, "graph_gap_m": 5.968406843133521e-07,
                    "odom_gap_max_m": 0.009740787661243592,
                    "odom_gap_rms_m": 0.005904226231557171},
        "counters": {"gn_iterations_per_scan": 5.375,
                     "host_syncs_per_scan": 0.0,
                     "preprocess_replay_share": 0.0}},
    "tiny_fleet": {
        "checked": {"attempted": 12,
                    "odom_gap_rms_m": 0.011487303833338557},
        "counters": {"gn_iterations_per_scan": None,
                     "host_syncs_per_scan": 0.0,
                     "preprocess_replay_share": 0.0}},
    "tiny_lio": {
        "checked": {"attempted": 8, "deskew_gap_m": 1.2426309092741515e-05,
                    "imu_guess_gap_m": 2.135878278986045e-17},
        "counters": {"gn_iterations_per_scan": 6.875,
                     "host_syncs_per_scan": 0.0,
                     "preprocess_replay_share": 0.0}},
}


def checked(capsys, name: str) -> dict:
    make, seed = CELLS[name]
    torch.set_num_threads(2)
    assert run.main(["--workload", name, "--seed", str(seed), "--seconds",
                     "0", "--trace", "0"], cell=make(),
                    device=torch.device("cpu")) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    return {"attempted": line["attempted"],
            **{k: v["value"] for k, v in line["checked"].items()}}


def counted(name: str) -> dict:
    """The counter readers over one session run under the profiler."""
    from lis_slam_torch.utils import profiling

    make, seed = CELLS[name]
    torch.set_num_threads(2)
    cell, dev = make(), torch.device("cpu")
    cfg = program.build_config(cell.config)
    tr = traffic.generate(cell.traffic, seed, dev,
                          extrinsic_rot=cfg.imu.extrinsic_rot)
    probes = P.Probes().install()
    try:
        sessions = program.sessions_for(cell.traffic["session"])(
            cfg, cell.config, tr, dev, probes)
        profiling.reset_counters()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            s = sessions.run(traced=True, capture=False)
    finally:
        probes.uninstall()
    rec = RunRecord()
    rec.trace_scans = s.scans
    out = {m: metric_reader(m)(rec) for m in COUNTERS}
    profiling.reset_counters()
    return out


@pytest.mark.parametrize("name", sorted(CELLS))
def test_checked_numbers_are_the_pinned_ones(capsys, name):
    assert checked(capsys, name) == PINNED[name]["checked"]


@pytest.mark.parametrize("name", sorted(CELLS))
def test_counter_readings_are_the_pinned_ones(name):
    assert counted(name) == PINNED[name]["counters"]
