"""RangeNet's keyframe labelling on its own projection replayed as one CUDA
graph (semantic/inference.py `infer_own_labels` through utils/graphs.py),
on the card. Every test here is marked `cuda` and skips without a GPU;
the file imports no JAX:

    python -m pytest tests/test_torch_rangenet_graph_cuda.py -m cuda \
        --noconftest

darknet53 at its published widths, seeded weights, bf16, on rendered
HDL-64 scans padded to 150000 points, at the net's 64 x 2048 input: the
first call of a net captures (eagerly), the replays after it are the
eager chain bit for bit in every field (image, mask, logits, labels, each
point's label), wait on the card nowhere, and share no memory with the
graph; once the net is freed, no graph of it is left.
"""

import gc

import pytest
import torch

from lis_slam_torch.config import SemanticConfig, kitti_config
from lis_slam_torch.io import synthetic_torch
from lis_slam_torch.models import rangenet
from lis_slam_torch.pipeline import driver
from lis_slam_torch.semantic import inference, weights
from lis_slam_torch.utils import graphs, profiling

pytestmark = pytest.mark.cuda

N_SCANS = 3  # the first captures; two replays after it


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs run only on the card")
    graphs.clear()
    profiling.reset_counters()
    yield torch.device("cuda", 0)
    graphs.clear()
    profiling.reset_counters()


def _net(cfg, dev):
    tree = rangenet.init_params(cfg.semantic,
                                torch.Generator().manual_seed(53))
    with torch.device(dev):
        model = rangenet.create_model(cfg.semantic)
    model.load_state_dict(weights.to_torch_state(tree, cfg.semantic))
    return model


def test_labelling_replays_are_the_eager_chain(dev, monkeypatch):
    cfg = kitti_config().replace(semantic=SemanticConfig(
        enabled=True, own_projection=True))
    raw, _gt = synthetic_torch.render_sequence_device(N_SCANS, seed=5,
                                                      device=dev)
    scans = [driver.pad_scan(p[v].cpu().numpy(), cfg, dev)
             for p, _lab, v in raw]
    assert scans[0].points.shape == (150_000, 4)
    model = _net(cfg, dev)
    with monkeypatch.context() as m:
        m.setattr(graphs, "_on_card", lambda inputs: False)
        wants = [inference.infer_own_labels(model, (s.points, s.valid), cfg)
                 for s in scans]
    outs = []
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        for i, s in enumerate(scans):
            torch.cuda.set_sync_debug_mode("error" if i else "default")
            try:
                outs.append(inference.infer_own_labels(
                    model, (s.points, s.valid), cfg))
            finally:
                torch.cuda.set_sync_debug_mode("default")
    assert profiling.counters()["rangenet_replays"] == N_SCANS - 1
    assert len(graphs._graphs) == 1
    for out, want in zip(outs, wants):
        for name, g, w in zip(want._fields, out, want):
            assert g.dtype == w.dtype and torch.equal(g, w), name
            assert g.stride() == w.stride(), name
    static = {t.untyped_storage().data_ptr()
              for cap in graphs._graphs.values()
              for t in graphs._leaves(cap.outputs) + list(cap.inputs)}
    for out in outs:
        assert not static & {t.untyped_storage().data_ptr()
                             for t in graphs._leaves(out)}
    out = outs[-1]
    assert out.logits.shape == (64, 2048, 20)
    assert int(out.mask.sum()) > 50_000
    assert int((out.point_labels > 0).sum()) > 50_000

    del model
    gc.collect()
    assert not graphs._graphs
