"""The darknet53 cell's pieces on the CPU: the check `rangenet_logits`,
the weights `rangenet_seeded_loaded`, the reference's operation count and
the four readers of the semantic inference layer.

- A tiny cell (16 x 900 plaza scans, 8 a session, slim widths at a 16 x
  512 input, labels inferred on the net's own projection, the net loaded
  once) run end to end with the cell's limits: correct, both numbers in
  `checked` below their limits; the check kept every sampled keyframe
  and four more; every session shares the one net.
- The same captures with 5% of the program's labels moved to another
  class read a label margin over the cell's limit; the fp8 control reads
  over at least one limit.
- The reference's operation count at darknet53's widths and 64 x 2048
  equals torch's flop counter over the reference's own forward on the
  meta device (626536742912), and its bytes are what its docstring
  counts.
- The readers: each from the program's counters, spans and device time,
  null where the program has none of them.
"""

import json
from pathlib import Path

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from lis_slam_torch.utils import profiling
from perfbench import run
from perfbench.checks import rangenet_logits as check
from perfbench.harness import program, spec, traffic, window
from perfbench.harness import probes as P
from perfbench.harness.spec import Cell, metric_reader
from perfbench.harness.trace import TraceSummary
from perfbench.reference import rangenet as R
from perfbench.tests import test_bench_correct

HERE = Path(__file__).resolve().parent
SEED = 4294967311
CELL_LIMITS = spec.load_cell("hdl64_slam_darknet53").limits
# the judge's limits at this size (test_bench_correct), the check's the
# cell's own
LIMITS = dict(test_bench_correct.LIMITS,
              **{k: CELL_LIMITS[k] for k in check.NUMBERS})
DARKNET53 = {"blocks": (1, 2, 8, 8, 4), "widths": (64, 128, 256, 512, 1024),
             "dec_widths": (512, 256, 128, 64, 32), "classes": 20,
             "in_channels": 5}


def _config():
    config = json.loads((HERE / "tiny_config.json").read_text())
    config["overrides"].update({
        "semantic.enabled": True, "semantic.own_projection": True,
        "semantic.model_input_h": 16, "semantic.model_input_w": 512,
        "semantic.enc_blocks": [1, 1, 2, 2, 2],
        "semantic.enc_widths": [16, 32, 64, 96, 128],
        "semantic.dec_widths": [96, 64, 48, 32, 24]})
    config["weights"] = {"rangenet": "rangenet_seeded_loaded", "seed": 7}
    return config


def _traffic():
    params = json.loads((HERE / "tiny_traffic.json").read_text())
    params["labels"] = "none"
    return params


@pytest.fixture(scope="module")
def session():
    """(configuration, traffic, the judged session, the sampled scans) of
    a tiny infer session with the check installed."""
    torch.set_num_threads(2)
    config, dev = _config(), torch.device("cpu")
    cfg = program.build_config(config)
    tr = traffic.generate(_traffic(), SEED, dev)
    probes = P.Probes().install({"rangenet_logits": check})
    nets = []
    try:
        sessions = program.sessions_for("semantic_slam")(cfg, config, tr,
                                                         dev, probes)
        orig = sessions.run

        def run_once(*a, **kw):  # the net each session's system holds
            s = orig(*a, **kw)
            nets.append(sessions.system_kw["rangenet_params"])
            return s
        sessions.run = run_once
        sample = set(traffic.sample_indices(len(tr.scans), 4, SEED))
        rec = window.run_window(sessions, probes, 0.0, False, sample)
        rec2 = window.run_window(sessions, probes, 0.0, False, sample)
    finally:
        probes.uninstall()
    assert len(nets) == 2 and nets[0] is nets[1]
    assert type(nets[0]).__name__ == "RangeNet"
    return config, tr, rec, rec2, sample


def test_the_check_keeps_the_sampled_keyframes_and_four_more(session):
    _config, _tr, rec, rec2, sample = session
    for r in (rec, rec2):
        kept = [c["scan"] for c in r.judged.checks["rangenet_logits"]]
        assert kept == sorted(set(kept)) and len(kept) >= 4
        assert len(set(kept) - sample) == check.UNSAMPLED
        assert r.stage_s["rangenet"][0] == 8  # every scan a keyframe here
        assert set(kept) >= sample


def test_a_tiny_infer_cell_is_correct_with_its_numbers(capsys):
    torch.set_num_threads(2)
    cell = Cell(name="tiny_infer", chips=1, config=_config(),
                traffic=_traffic(), limits=dict(LIMITS),
                end_to_end=test_bench_correct._cell().end_to_end,
                per_layer=[], run_seconds=1)
    assert run.main(["--workload", "tiny_infer", "--seed", str(SEED),
                     "--seconds", "0", "--trace", "0"], cell=cell,
                    device=torch.device("cpu")) == 0
    out = capsys.readouterr()
    line = json.loads(out.out.strip().splitlines()[-1])
    assert line["correct"] is True and line["failed"] == 0
    assert list(line["checked"]) == sorted(LIMITS)
    for name in check.NUMBERS:
        got = line["checked"][name]
        assert 0 < got["value"] <= got["limit"] == CELL_LIMITS[name]


def test_labels_moved_to_another_class_fail(session):
    config, tr, rec, _rec2, _sample = session
    captured = rec.judged.checks["rangenet_logits"]
    sound = check.readings(captured, config, tr, torch.device("cpu"))
    assert all(sound[k] <= CELL_LIMITS[k] for k in check.NUMBERS), sound
    gen = torch.Generator().manual_seed(5)
    moved = []
    for item in captured:
        lab = item["labels"].clone()
        flip = item["mask"] & (torch.rand(lab.shape, generator=gen) < 0.05)
        lab[flip] = (lab[flip] + 1 + torch.randint(
            0, 19, (int(flip.sum()),), generator=gen).to(lab.dtype)) % 20
        moved.append(dict(item, labels=lab))
    bad = check.readings(moved, config, tr, torch.device("cpu"))
    assert bad["rangenet_label_margin"] > CELL_LIMITS["rangenet_label_margin"]
    assert bad["rangenet_logit_gap"] == sound["rangenet_logit_gap"]


def test_the_fp8_control_fails(session):
    config, tr, rec, _rec2, _sample = session
    captured = rec.judged.checks["rangenet_logits"]
    ctl = check.control(captured, config, tr, torch.device("cpu"))
    assert any(ctl[k] > CELL_LIMITS[k] for k in check.NUMBERS), ctl


def test_nothing_kept_reads_inf():
    for f in (check.readings, check.control):
        assert all(v == float("inf") for v in f([], _config(), None,
                                                 torch.device("cpu")).values())


def _meta_tree():
    from lis_slam_torch.config import SemanticConfig
    from lis_slam_torch.models import rangenet

    cfg = SemanticConfig(enabled=True)
    with torch.device("meta"):
        shapes = {k: tuple(v.shape) for k, v in
                  rangenet.create_model(cfg).state_dict().items()}
    params, stats = {}, {}

    def put(tree, path, leaf, shape):
        for p in path.split("/"):
            tree = tree.setdefault(p, {})
        tree[leaf] = torch.empty(shape, device="meta")

    for path, kind in rangenet.expected_layer_sequence(cfg):
        w = shapes[path.replace("/", ".") + ".weight"]
        if kind == "bn":
            for leaf in ("scale", "bias"):
                put(params, path, leaf, w)
            for leaf in ("mean", "var"):
                put(stats, path, leaf, w)
            continue
        o, i, kh, kw = w if kind != "deconv" else (w[1], w[0], *w[2:])
        put(params, path, "kernel", (kh, kw, i, o))
        if kind == "convb":
            put(params, path, "bias", (o,))
    return {"params": params, "batch_stats": stats}


def test_the_reference_counts_what_the_flop_counter_counts():
    tree = _meta_tree()
    with FlopCounterMode(display=False) as counter:
        out = R.forward(tree, torch.empty(1, 64, 2048, 5, device="meta"))
    assert out.shape == (1, 64, 2048, 20)
    assert counter.get_total_flops() == R.flops(DARKNET53, 64, 2048) \
        == 626_536_742_912
    kernels = sum(t.numel() for k, t in _leaves(tree["params"])
                  if k == "kernel")
    n_bn = sum(t.numel() for k, t in _leaves(tree["params"])
               if k == "scale")
    head = tree["params"]["Conv_0"]
    head_n = head["kernel"].numel() + head["bias"].numel()
    assert R.bytes_moved(DARKNET53, 64, 2048) == (
        2 * (kernels - head["kernel"].numel()) + 4 * head_n + 16 * n_bn
        + 4 * 64 * 2048 * (5 + 20))
    assert R.least_seconds(DARKNET53, 64, 2048) == pytest.approx(
        626_536_742_912 / 989.4e12)


def _leaves(tree):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield k, v


def _rec(captured=True):
    rec = window.RunRecord()
    rec.trace = TraceSummary(busy_s=1.0, window_s=2.0, launches=0,
                             device_ops=[], idle_gaps=[], kernel_s={},
                             stage_device_s={"rangenet": 0.02})
    rec.stage_s = {"rangenet": [4, 0.004]}
    judged = program.Session()
    if captured:
        judged.checks = {"rangenet_logits": [
            {"image": torch.zeros(64, 2048, 5), "arch": DARKNET53}]}
    rec.judged = judged
    return rec


@pytest.fixture
def counted():
    """A profiled run of 4 labelled keyframes, 3 of them replays."""
    profiling.reset_counters()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        for i in range(4):
            profiling.count("rangenet_forwards")
            if i:
                profiling.count("rangenet_replays")
    yield
    profiling.reset_counters()


def test_the_readers(counted):
    rec = _rec()
    assert metric_reader("rangenet_ms")(rec) == pytest.approx(1.0)
    assert metric_reader("rangenet_device_ms")(rec) == pytest.approx(5.0)
    assert metric_reader("rangenet_replay_share")(rec) == pytest.approx(0.75)
    assert metric_reader("rangenet_roofline")(rec) == pytest.approx(
        100 * 4 * R.least_seconds(DARKNET53, 64, 2048) / 0.02)
    assert metric_reader("rangenet_roofline")(_rec(False)) is None


def test_the_readers_are_null_without_the_programs_counters(monkeypatch):
    """The parent of these metrics' program counts no forward."""
    rec = _rec()
    rec.stage_s = {}
    monkeypatch.setattr(profiling, "counters",
                        lambda stage=None: {"scans": 4, "host_syncs": 0})
    for name in ("rangenet_ms", "rangenet_device_ms", "rangenet_roofline",
                 "rangenet_replay_share"):
        assert metric_reader(name)(rec) is None, name
