"""The batched replay's check on the CPU at a size a test can hold (2
lanes of 6 16 x 900 plaza scans): a sound replay is correct, the bfloat16
control is not, and a step that leaves half of the lanes out (their
poses held at the guess) is not."""

import json
from pathlib import Path

import torch

from perfbench import run
from perfbench.harness import judge, program, traffic, window
from perfbench.harness import probes as P
from perfbench.harness.spec import Cell

HERE = Path(__file__).resolve().parent
# at this size the CPU's float32 rows leave the program 4-24 mm from the
# float64 reference scan by scan (a lower RMS); the control's RMS is over
# the limit
LIMITS = {"odom_gap_rms_m": 0.04}
TRAFFIC = {"session": "replay_batched", "world": "plaza", "beams": "vlp16",
           "horizon": 900, "radius": 10.0, "lap_scans": 100, "renders": [6],
           "lanes": 2, "sample": 4}


def _cell():
    return Cell(name="tiny_fleet", chips=1,
                config=json.loads((HERE / "tiny_config.json").read_text()),
                traffic=dict(TRAFFIC), limits=dict(LIMITS),
                end_to_end=[{"name": "scans_per_s", "unit": "scans/s"},
                            {"name": "setup_s", "unit": "s"}],
                per_layer=[], run_seconds=1)


def _run(capsys):
    torch.set_num_threads(2)
    assert run.main(["--workload", "tiny_fleet", "--seed", "99",
                     "--seconds", "0", "--trace", "0"], cell=_cell(),
                    device=torch.device("cpu")) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_sound_replay_is_correct(capsys):
    line = _run(capsys)
    assert line["correct"] is True, line["checked"]
    assert line["attempted"] == 12
    assert set(line["metrics"]) == {"scans_per_s", "setup_s"}


def test_the_control_fails_at_this_size():
    torch.set_num_threads(2)
    cell = _cell()
    dev = torch.device("cpu")
    cfg = program.build_config(cell.config)
    tr = traffic.generate(cell.traffic, 99, dev)
    probes = P.Probes().install()
    try:
        sessions = program.sessions_for("replay_batched")(cfg, cell.config, tr,
                                                      dev, probes)
        rec = window.run_window(sessions, probes, 0.0, False,
                                set(traffic.sample_indices(6, 4, 99)))
    finally:
        probes.uninstall()
    prob = judge.problem_of(rec.judged, cfg, tr)
    assert len(prob.captures) == 8  # 4 steps x 2 lanes
    ok, _rows = judge.verdict(judge.readings(prob), LIMITS)
    assert ok
    ok, rows = judge.verdict(judge.readings(prob, judge.control_answers(prob)),
                             LIMITS)
    assert not ok, rows


def test_half_of_the_lanes_left_out_is_not_correct(capsys, monkeypatch):
    from lis_slam_torch.ops import scan_match

    orig = scan_match.scan_to_map_scheduled

    def half(pose0, *args, **kw):
        st = orig(pose0, *args, **kw)
        b = pose0.shape[0]
        pose = st.pose.clone()
        pose[b // 2:] = pose0[b // 2:]
        return st._replace(pose=pose)

    monkeypatch.setattr(scan_match, "scan_to_map_scheduled", half)
    line = _run(capsys)
    assert line["correct"] is False
