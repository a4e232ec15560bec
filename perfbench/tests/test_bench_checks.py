"""Checks brought as files (perfbench/checks/): a tiny cell whose limits
name a check's number runs it end to end, the number in `checked` beside
its limit; the check's control reads over that limit; a limits key that
nothing forms stops the run in set-up; and the cells of BENCHMARK.json
install exactly the probes' own twelve wrappers and no check."""

import json
import subprocess
import sys

import pytest
import torch

from perfbench import run
from perfbench.harness import judge, program, spec, traffic, window
from perfbench.harness import probes as P
from perfbench.tests import pose_check, test_bench_correct

LIMITS = dict(test_bench_correct.LIMITS, pose_matrix_gap=1e-4)
SEED = 4294967311
# the probes' own wrappers, the same in every cell
TODAY = [
    ("lis_slam_torch.pipeline.odometry", "_odom_step_impl"),
    ("lis_slam_torch.ops.scan_match", "scan_to_map"),
    ("lis_slam_torch.pipeline.odometry", "_odom_step_lanes"),
    ("lis_slam_torch.ops.scan_match", "scan_to_map_scheduled"),
    ("lis_slam_torch.ops.gn_solve", "solve"),
    ("lis_slam_torch.ops.gn_solve", "scalar_rows"),
    ("lis_slam_torch.ops.knn_cuda", "knn"),
    ("lis_slam_torch.ops.knn_cuda", "knn_lanes"),
    ("lis_slam_torch.ops.gn_cuda", "gn_iteration_vec"),
    ("lis_slam_torch.ops.gn_cuda", "gn_iteration_lanes"),
    ("lis_slam_torch.pipeline.lio", "_lio_prestep"),
    ("lis_slam_torch.ops.deskew", "deskew_points"),
]


@pytest.fixture
def with_check(monkeypatch):
    """The harness finds the test's check as it finds perfbench/checks/."""
    monkeypatch.setattr(spec, "check_modules",
                        lambda: {"pose_check": pose_check})


def _cell(limits):
    cell = test_bench_correct._cell()
    cell.limits = dict(limits)
    return cell


def _main(limits):
    torch.set_num_threads(2)
    return run.main(["--workload", "tiny", "--seed", str(SEED), "--seconds",
                     "0", "--trace", "0"], cell=_cell(limits),
                    device=torch.device("cpu"))


def _line(capsys):
    out = capsys.readouterr()
    return json.loads(out.out.strip().splitlines()[-1]), out.err


def test_a_checks_number_is_checked_beside_its_limit(capsys, with_check):
    assert _main(LIMITS) == 0
    line, err = _line(capsys)
    assert line["correct"] is True and line["failed"] == 0
    assert list(line["checked"]) == sorted(LIMITS)
    got = line["checked"]["pose_matrix_gap"]
    assert got["limit"] == 1e-4 and 0.0 <= got["value"] <= 1e-4
    assert f"check pose_matrix_gap = {got['value']!r} (limit 0.0001)" in err


def test_a_checks_number_over_its_limit_is_not_correct(capsys, with_check,
                                                       monkeypatch):
    """The program's matrices 1 mm off where they are formed."""
    from lis_slam_torch.utils import se3

    orig = se3.pose_to_matrix

    def off(pose6):
        T = orig(pose6)
        if pose6.dim() == 1:
            T = T.clone()
            T[0, 3] += 1e-3
        return T
    monkeypatch.setattr(se3, "pose_to_matrix", off)
    assert _main(LIMITS) == 0
    line, _err = _line(capsys)
    assert line["correct"] is False
    assert line["checked"]["pose_matrix_gap"]["value"] > 9e-4


def test_the_checks_control_reads_over_its_limit():
    torch.set_num_threads(2)
    cell, dev = _cell(LIMITS), torch.device("cpu")
    cfg = program.build_config(cell.config)
    tr = traffic.generate(cell.traffic, SEED, dev)
    probes = P.Probes().install({"pose_check": pose_check})
    try:
        sessions = program.sessions_for("semantic_slam")(
            cfg, cell.config, tr, dev, probes)
        sample = set(traffic.sample_indices(len(tr.scans), 4, SEED))
        rec = window.run_window(sessions, probes, 0.0, False, sample)
    finally:
        probes.uninstall()
    captured = rec.judged.checks["pose_check"]
    assert captured
    numbers = judge.readings(judge.problem_of(rec.judged, cfg, tr))
    assert set(numbers) <= set(spec.JUDGE_NUMBERS)
    sound = pose_check.readings(captured, cell.config, tr, dev)
    ctl = pose_check.control(captured, cell.config, tr, dev)
    assert sound["pose_matrix_gap"] <= LIMITS["pose_matrix_gap"]
    assert ctl["pose_matrix_gap"] > 10 * LIMITS["pose_matrix_gap"], ctl


def test_a_key_nothing_forms_stops_the_run_in_set_up(capsys, with_check,
                                                     monkeypatch):
    def no_set_up(*a, **kw):
        raise AssertionError("set-up went on")
    monkeypatch.setattr(traffic, "generate", no_set_up)
    with pytest.raises(SystemExit) as e:
        _main(dict(LIMITS, no_such_number=1.0))
    assert e.value.code != 0
    out = capsys.readouterr()
    assert "'no_such_number'" in out.err and not out.out


def test_sorting_the_limits_imports_no_reference():
    """Set-up sorts a cell's limits without the judge and its scipy
    references, whose import would count in setup_s."""
    code = ("import sys; from perfbench.harness import spec; "
            "[spec.checks_for(spec.load_cell(w['name']).limits) "
            "for w in spec.load_benchmark()['workloads']]; "
            "print(sorted({'perfbench.harness.judge', 'scipy', 'numpy'} "
            "& set(sys.modules)))")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_two_checks_forming_one_number_are_refused(monkeypatch):
    monkeypatch.setattr(spec, "check_modules",
                        lambda: {"a": pose_check, "b": pose_check})
    with pytest.raises(ValueError, match="pose_matrix_gap"):
        spec.checks_for(LIMITS)


@pytest.mark.parametrize("cell", [w["name"] for w in
                                  spec.load_benchmark()["workloads"]])
def test_the_cells_install_todays_patches_and_no_check(cell):
    checks = spec.checks_for(spec.load_cell(cell).limits)
    assert checks == {}
    probes = P.Probes().install(checks)
    try:
        assert [(m.__name__, n) for m, n, _f in probes._undo] == TODAY
    finally:
        probes.uninstall()


def test_a_checks_wrapper_is_installed_and_restored():
    from lis_slam_torch.utils import se3

    orig = se3.pose_to_matrix
    probes = P.Probes().install({"pose_check": pose_check})
    try:
        assert [(m.__name__, n) for m, n, _f in probes._undo] == TODAY + [
            ("lis_slam_torch.utils.se3", "pose_to_matrix")]
        assert se3.pose_to_matrix is not orig
    finally:
        probes.uninstall()
    assert se3.pose_to_matrix is orig
