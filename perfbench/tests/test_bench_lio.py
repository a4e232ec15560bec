"""The LIO cell's check on the CPU at a size a test can hold (8 distorted
16 x 900 sweeps of the city blocks with their IMU rows): a sound run is
correct, the control (the IMU chain in float32, the deskew with bfloat16
storage) is not, and so is not a run whose IMU chain or deskew is broken
underneath the probes."""

import json
from pathlib import Path

import pytest
import torch

from perfbench import run
from perfbench.harness import judge, program, traffic, window
from perfbench.harness import probes as P
from perfbench.harness.spec import Cell

HERE = Path(__file__).resolve().parent
# at this size: the program's guess 3e-17 m from the float64 chain and its
# deskew 1.5e-5 m from the float64 one; the control 3e-7 m and 0.5 m
LIMITS = {"imu_guess_gap_m": 1e-9, "deskew_gap_m": 0.002}
TRAFFIC = {"session": "lio_odometry", "world": "blocks", "world_seed": 5,
           "beams": "vlp16", "horizon": 900, "radius": 60.0, "speed": 8.0,
           "renders": [8], "distorted": True, "imu": True, "labels": "none",
           "sample": 4}
SEED = 2147483659


def _cell():
    return Cell(name="tiny_lio", chips=1,
                config=json.loads((HERE / "tiny_lio_config.json").read_text()),
                traffic=dict(TRAFFIC), limits=dict(LIMITS),
                end_to_end=[{"name": "scans_per_s", "unit": "scans/s"},
                            {"name": "setup_s", "unit": "s"}],
                per_layer=[], run_seconds=1)


def _run(capsys):
    torch.set_num_threads(2)
    assert run.main(["--workload", "tiny_lio", "--seed", str(SEED),
                     "--seconds", "0", "--trace", "0"], cell=_cell(),
                    device=torch.device("cpu")) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_sound_run_is_correct_and_the_control_is_not():
    torch.set_num_threads(2)
    cell = _cell()
    dev = torch.device("cpu")
    cfg = program.build_config(cell.config)
    tr = traffic.generate(cell.traffic, SEED, dev,
                          extrinsic_rot=cfg.imu.extrinsic_rot)
    probes = P.Probes().install()
    try:
        sessions = program.sessions_for("lio_odometry")(cfg, cell.config, tr,
                                                        dev, probes)
        rec = window.run_window(sessions, probes, 0.0, False,
                                set(traffic.sample_indices(8, 4, SEED)))
    finally:
        probes.uninstall()
    prob = judge.problem_of(rec.judged, cfg, tr, lio=True)
    assert len(prob.imu_steps) == 7 and len(prob.deskews) == 4
    ok, rows = judge.verdict(judge.readings(prob), LIMITS)
    assert ok, rows
    ctl = judge.readings(prob, judge.control_answers(prob))
    assert ctl["imu_guess_gap_m"] > LIMITS["imu_guess_gap_m"]
    assert ctl["deskew_gap_m"] > LIMITS["deskew_gap_m"]


def _break_preintegration(monkeypatch):
    """The previous window integrated whole, not clipped to the interval
    between the two scans' start stamps."""
    from lis_slam_torch.imu import preintegration as pi

    orig = pi.preintegrate

    def unclipped(*a, t0=None, t1=None, **kw):
        return orig(*a, **kw)
    monkeypatch.setattr(pi, "preintegrate", unclipped)


def _break_velocity_update(monkeypatch):
    """The two-window refresh hands back the nav state unchanged."""
    from lis_slam_torch.pipeline import lio

    def unchanged(imu_state, pre1, pre2, pose0, pose1, pose2, v0_est,
                  fail_acc, cfg):
        return imu_state, v0_est, fail_acc
    monkeypatch.setattr(lio, "_lio_poststep2", unchanged)


def _break_deskew(monkeypatch):
    """The deskew leaves out the body velocity's term."""
    from lis_slam_torch.ops import deskew

    orig = deskew.deskew_points

    def rotation_only(points, t, info, valid, vel_body=None):
        return orig(points, t, info, valid, vel_body=None)
    monkeypatch.setattr(deskew, "deskew_points", rotation_only)


@pytest.mark.parametrize("fault", [_break_preintegration,
                                   _break_velocity_update, _break_deskew])
def test_a_broken_lio_chain_is_not_correct(capsys, monkeypatch, fault):
    fault(monkeypatch)
    line = _run(capsys)
    assert line["correct"] is False, line["checked"]
