"""Weights named by a configuration (perfbench/weights/): a tiny
SemanticSlam session whose configuration names seeded RangeNet weights at
the slim widths labels its keyframes by inference through them, and is
judged as any session is; the weights follow the configuration's seed;
a configuration that names none builds the program as before."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench.harness import judge, program, traffic, window
from perfbench.harness import probes as P
from perfbench.tests import test_bench_correct
from perfbench.weights import rangenet_seeded

HERE = Path(__file__).resolve().parent
SLIM = {"semantic.enabled": True, "semantic.enc_blocks": [1, 1, 2, 2, 2],
        "semantic.enc_widths": [16, 32, 64, 96, 128],
        "semantic.dec_widths": [96, 64, 48, 32, 24]}
SEED = 4294967311


def _config(weights=True):
    config = json.loads((HERE / "tiny_config.json").read_text())
    config["overrides"].update(SLIM)
    if weights:
        config["weights"] = {"rangenet": "rangenet_seeded", "seed": 7}
    return config


def _leaves(tree):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield k, v


def test_the_weights_follow_the_configurations_seed():
    cfg = program.build_config(_config())
    dev = torch.device("cpu")
    a, b = (rangenet_seeded.build(cfg, 7, dev) for _ in range(2))
    c = rangenet_seeded.build(cfg, 8, dev)
    la, lb, lc = (list(_leaves(t)) for t in (a, b, c))
    assert [k for k, _ in la] == [k for k, _ in lc]
    assert all(np.array_equal(x, y) for (_k, x), (_j, y) in zip(la, lb))
    assert not all(np.array_equal(x, y) for (_k, x), (_j, y) in zip(la, lc))
    kernels = [v for k, v in la if k == "kernel"]
    assert kernels and all(v.dtype == np.float32 for v in kernels)


@pytest.mark.parametrize("weights", [False, True])
def test_a_configuration_names_its_weights_or_none(weights):
    config = _config(weights)
    cfg = program.build_config(config)
    tr = traffic.Traffic(scans=[], gt=np.zeros((0, 6)), params={})
    s = program.sessions_for("semantic_slam")(cfg, config, tr,
                                              torch.device("cpu"), None)
    assert set(s.system_kw) == ({"rangenet_params"} if weights else set())


def test_an_infer_session_with_seeded_weights():
    torch.set_num_threads(2)
    config, dev = _config(), torch.device("cpu")
    cfg = program.build_config(config)
    params = json.loads((HERE / "tiny_traffic.json").read_text())
    params["labels"] = "none"
    tr = traffic.generate(params, SEED, dev)
    assert all(s.labels is None for s in tr.scans)
    probes = P.Probes().install()
    try:
        sessions = program.sessions_for("semantic_slam")(cfg, config, tr,
                                                         dev, probes)
        sample = set(traffic.sample_indices(len(tr.scans), 4, SEED))
        rec = window.run_window(sessions, probes, 0.0, False, sample)
    finally:
        probes.uninstall()
    # RangeNet labelled the keyframes
    assert rec.stage_s["rangenet"][0] >= 1
    prob = judge.problem_of(rec.judged, cfg, tr)
    ok, rows = judge.verdict(judge.readings(prob), test_bench_correct.LIMITS)
    assert ok, rows
