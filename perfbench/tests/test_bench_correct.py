"""`correct` decided by the references, driven through a whole run on the
CPU at a size a test can hold (16 x 900 scans of the plaza, 8 a session):
a sound run is correct, the bfloat16 control is not, and each fault the
cells can have turns `correct` false: a step that returns its state
unchanged, and an answer altered where it is produced."""

import json
from pathlib import Path

import pytest
import torch

from perfbench import run
from perfbench.harness import judge, program, traffic, window
from perfbench.harness import probes as P
from perfbench.harness.spec import Cell

HERE = Path(__file__).resolve().parent
# limits at this size, set as the cells' are: above the sound runs'
# readings (odom RMS 3-5 mm, graph < 1e-6 m), below the bfloat16
# control's (odom RMS several cm)
LIMITS = {"odom_gap_rms_m": 0.015, "odom_gap_max_m": 0.03,
          "graph_gap_m": 0.002}


def _cell():
    return Cell(name="tiny", chips=1,
                config=json.loads((HERE / "tiny_config.json").read_text()),
                traffic=json.loads((HERE / "tiny_traffic.json").read_text()),
                limits=dict(LIMITS),
                end_to_end=[{"name": "scans_per_s", "unit": "scans/s"},
                            {"name": "scan_ms_p95", "unit": "ms"},
                            {"name": "setup_s", "unit": "s"}],
                per_layer=[], run_seconds=1)


def _run(capsys, seed=4294967311):
    torch.set_num_threads(2)
    assert run.main(["--workload", "tiny", "--seed", str(seed),
                     "--seconds", "0", "--trace", "0"], cell=_cell(),
                    device=torch.device("cpu")) == 0
    out = capsys.readouterr()
    line = json.loads(out.out.strip().splitlines()[-1])
    return line, out.err


def test_sound_run_is_correct_and_prints_its_numbers(capsys):
    line, err = _run(capsys)
    assert set(line) == {"correct", "attempted", "failed", "metrics",
                         "device", "checked"}
    assert list(line)[-1] == "checked"
    assert line["correct"] is True and line["failed"] == 0
    assert set(line["metrics"]) == {"scans_per_s", "scan_ms_p95", "setup_s"}
    for m in line["metrics"].values():
        assert m["value"] > 0 and m["unit"]
    assert set(line["checked"]) == set(LIMITS)
    last = err.strip().splitlines()[-len(LIMITS):]
    assert all(s.startswith("check ") and "limit" in s for s in last)


def test_the_control_fails_at_this_size():
    torch.set_num_threads(2)
    cell = _cell()
    dev = torch.device("cpu")
    cfg = program.build_config(cell.config)
    tr = traffic.generate(cell.traffic, 77, dev)
    probes = P.Probes().install()
    try:
        sessions = program.sessions_for("semantic_slam")(cfg, cell.config, tr,
                                                     dev, probes)
        sample = traffic.sample_indices(len(tr.scans), 4, 77)
        rec = window.run_window(sessions, probes, 0.0, False, set(sample))
    finally:
        probes.uninstall()
    prob = judge.problem_of(rec.judged, cfg, tr)
    ok, _rows = judge.verdict(judge.readings(prob), LIMITS)
    assert ok
    ctl = judge.readings(prob, judge.control_answers(prob))
    ok, rows = judge.verdict(ctl, LIMITS)
    assert not ok, rows


@pytest.fixture
def broken_step(monkeypatch):
    """Break the program's front-end step underneath the probes."""
    from lis_slam_torch.pipeline import odometry

    orig = odometry._odom_step_impl

    def install(kind):
        def step(state, scan, cfg):
            new, out, fc, ext = orig(state, scan, cfg)
            if kind == "state_unchanged" and int(state.kf_count) > 0:
                # the step hands back the state it was given
                return state, out._replace(pose=state.pose), fc, ext
            if kind == "answer_altered" and int(state.frame_idx) == 5:
                pose = out.pose.clone()
                pose[3] += 0.05
                return new, out._replace(pose=pose), fc, ext
            return new, out, fc, ext
        monkeypatch.setattr(odometry, "_odom_step_impl", step)
    return install


@pytest.mark.parametrize("kind", ["state_unchanged", "answer_altered"])
def test_a_broken_step_is_not_correct(capsys, broken_step, kind):
    broken_step(kind)
    # seed 4294967311 samples scans 0, 5, 6 and 7 of the 8
    assert 5 in traffic.sample_indices(8, 4, 4294967311)
    line, _err = _run(capsys)
    assert line["correct"] is False
    assert line["failed"] >= 1
