"""Keyframe labels on RangeNet's own projection (SemanticConfig.
own_projection, semantic/inference.py `infer_own_labels`), on the CPU.

- A rendered HDL-64 keyframe at the net's 64 x 2048 input, with the
  in-repo slim checkpoint: the mask equal to a plain numpy projection of
  the same pretreated points (each point's pixel from its ring and the
  front end's column, the nearest quantized range winning a pixel, the
  lower raw index on a tie), the normalized image within 2e-6 of the
  plain one (its range channel and normalization round differently in
  the last bit: norm_fma and a product with the float32 reciprocal of the
  stds against a float64 norm and a true division), and each point's
  label equal, on >= 99.9% of the points, to the plain readback of the
  net's argmax over the plain image at its pixel (an argmax can flip on
  a last-bit change of its input).
- A short SemanticSlam session given the loaded net, bit-equal in poses,
  the final graph's poses and every keyframe's labels to one given the
  weight tree; the net is used as given.
- Off the card the chain runs eagerly: no graph, no replay counted, the
  results those of `label_scan`.
- A graph tied to a net goes with the net (utils/graphs.py `owner`), the
  CUDA graph stood in for as in tests/test_torch_preprocess_graph.py.
"""

import gc

import numpy as np
import pytest
import torch

from lis_slam_torch.config import SemanticConfig, SensorConfig, SlamConfig
from lis_slam_torch.io import synthetic
from lis_slam_torch.models import rangenet
from lis_slam_torch.ops import pretreatment, projection
from lis_slam_torch.pipeline import driver, slam
from lis_slam_torch.semantic import inference
from lis_slam_torch.utils import graphs, profiling

from _torch_plaza import render_plaza, tiny_cfgs

IMAGE_ATOL = 2e-6  # last-bit rounding of the range and normalization
LABEL_AGREE = 0.999  # argmax flips on last-bit input changes
SLIM = dict(enc_blocks=(1, 1, 2, 2, 2), enc_widths=(16, 32, 64, 96, 128),
            dec_widths=(96, 64, 48, 32, 24))


@pytest.fixture(autouse=True)
def _fresh():
    graphs.clear()
    profiling.reset_counters()
    yield
    graphs.clear()
    profiling.reset_counters()


@pytest.fixture(scope="module")
def hdl64():
    """A rendered HDL-64 keyframe, the full-width config with its own
    projection, and the slim checkpoint's inference wrapper."""
    cfg = SlamConfig().replace(
        sensor=SensorConfig(max_raw_points=64 * 1800),
        semantic=SemanticConfig(enabled=True, own_projection=True))
    scan = synthetic.render_scan(synthetic.make_world(seed=31),
                                 np.array([0, 0, 0.7, 5.0, -3.0, 1.8]),
                                 seed=77)
    return scan, inference.SemanticInference(cfg, device="cpu")


def _plain_projection(pre, cfg):
    """(mask (H, W), image (H, W, 5) normalized, each point's pixel or -1)
    of pretreated points, in numpy."""
    sem, sensor = cfg.semantic, cfg.sensor
    h, w = sem.model_input_h, sem.model_input_w
    pts = pre.points.numpy()
    ring, valid = pre.ring.numpy(), pre.valid.numpy()
    col = projection.pixel_columns(pre.points, w).numpy()
    x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
    rng = np.sqrt(x * x + y * y + z * z)  # float32, the sort key's range
    ok = (valid & (rng >= sensor.lidar_min_range)
          & (rng <= sensor.lidar_max_range) & (ring >= 0) & (ring < h)
          & (col >= 0) & (col < w))
    pix = np.where(ok, ring * w + col, -1)
    rq = np.clip(rng * np.float32(16383.0 / sensor.lidar_max_range), 0,
                 16382).astype(np.int32)
    idx = np.flatnonzero(ok)
    order = idx[np.lexsort((idx, rq[idx], pix[idx]))]
    first = np.ones(len(order), bool)
    first[1:] = pix[order][1:] != pix[order][:-1]
    win = order[first]
    xyz64 = pts[win, :3].astype(np.float64)
    chans = np.concatenate([np.sqrt((xyz64 ** 2).sum(1))[:, None], xyz64,
                            pts[win, 3:4].astype(np.float64)], axis=1)
    chans = (chans - np.asarray(sem.img_means)) / np.asarray(sem.img_stds)
    image = np.zeros((h * w, 5), np.float32)
    image[pix[win]] = chans
    mask = np.zeros(h * w, bool)
    mask[pix[win]] = True
    return mask.reshape(h, w), image.reshape(h, w, 5), pix


def test_own_projection_against_a_plain_projection(hdl64):
    scan, wrap = hdl64
    cfg, model = wrap.cfg, wrap.model
    assert cfg.semantic.own_projection
    pts, valid = torch.from_numpy(scan.points), torch.from_numpy(scan.valid)
    pts, valid = (torch.nn.functional.pad(pts, (0, 0, 0, 64 * 1800 -
                                                len(pts))),
                  torch.nn.functional.pad(valid, (0, 64 * 1800 - len(valid))))
    out = inference.infer_own_labels(model, (pts, valid), cfg)
    pre = pretreatment.pretreat(pts, valid, cfg.sensor)
    mask, image, pix = _plain_projection(pre, cfg)
    assert out.image.shape == (64, 2048, 5) and out.mask.dtype == torch.bool
    np.testing.assert_array_equal(out.mask.numpy(), mask)
    # every ring of the grid, where the front end keeps every other one
    assert mask[1::2].sum() > 10_000 and mask.sum() > 50_000
    np.testing.assert_allclose(out.image.numpy(), image, rtol=0,
                               atol=IMAGE_ATOL)
    lab = torch.where(out.mask, out.logits.argmax(-1), 0)
    np.testing.assert_array_equal(out.labels.numpy(), lab.numpy())
    with torch.no_grad():
        plain = model(torch.from_numpy(image)[None])[0].argmax(-1).numpy()
    plain = np.where(mask, plain, 0).reshape(-1)
    want = np.where(pix >= 0, plain[np.maximum(pix, 0)], 0)
    got = out.point_labels.numpy()
    assert got.dtype == np.int32 and got.shape == want.shape
    hit = pix >= 0
    assert hit.sum() > 50_000 and (got[hit] > 0).mean() > 0.5
    assert (got == want)[hit].mean() >= LABEL_AGREE
    assert not got[~hit].any()


def _session_cfg():
    _j, cfg = tiny_cfgs()
    return cfg.replace(semantic=SemanticConfig(
        enabled=True, own_projection=True, model_input_h=16,
        model_input_w=512, **SLIM))


def _run(cfg, net, scans, monkeypatch):
    labels = []
    orig = inference.infer_own_labels

    def kept(model, inputs, c):
        out = orig(model, inputs, c)
        labels.append(out.point_labels.clone())
        return out
    with monkeypatch.context() as m:
        m.setattr(inference, "infer_own_labels", kept)
        system = slam.SemanticSlam(cfg, rangenet_params=net, device="cpu")
        poses = [system.process_scan(driver.pad_scan(
            s.points[s.valid], cfg, "cpu")).clone() for s in scans]
        res = system.finish()
    return system, torch.stack(poses), np.asarray(res.poses), labels


def test_a_loaded_net_labels_as_its_tree(monkeypatch):
    torch.set_num_threads(2)
    cfg = _session_cfg()
    tree = rangenet.init_params(cfg.semantic,
                                torch.Generator().manual_seed(7))
    net = inference.load_model(tree, cfg.semantic, "cpu")
    scans, _gt = render_plaza(8, seed0=640)
    sys_t, poses_t, graph_t, lab_t = _run(cfg, tree, scans, monkeypatch)
    sys_n, poses_n, graph_n, lab_n = _run(cfg, net, scans, monkeypatch)
    assert sys_n.model is net and sys_t.model is not net
    assert torch.equal(poses_t, poses_n)
    np.testing.assert_array_equal(graph_t, graph_n)
    assert len(lab_t) == len(lab_n) >= 3
    for a, b in zip(lab_t, lab_n):
        assert torch.equal(a, b)
    assert all(int((a > 0).sum()) > 1000 for a in lab_n)


def test_off_the_card_the_labelling_runs_eagerly():
    cfg = _session_cfg()
    net = inference.load_model(rangenet.init_params(
        cfg.semantic, torch.Generator().manual_seed(7)), cfg.semantic, "cpu")
    scans, _gt = render_plaza(1, seed0=640)
    sin = driver.pad_scan(scans[0].points[scans[0].valid], cfg, "cpu")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        outs = [inference.infer_own_labels(net, (sin.points, sin.valid), cfg)
                for _ in range(2)]
    assert not graphs._graphs
    assert profiling.counters()["rangenet_replays"] == 0
    want = inference.label_scan(net, sin.points, sin.valid, cfg)
    for out in outs:
        for name, g, w in zip(want._fields, out, want):
            assert torch.equal(g, w), name


def test_a_nets_graph_goes_with_the_net(monkeypatch):
    """Two nets, a graph each; freeing one drops its graph alone."""
    monkeypatch.setattr(graphs, "_on_card", lambda inputs: True)

    def capture(fn, inputs):  # keeps no reference to the chain or its net
        static = tuple(t.clone() for t in inputs)
        return (lambda: None), static, fn(*static)
    monkeypatch.setattr(graphs, "_capture", capture)
    cfg = _session_cfg()
    tree = rangenet.init_params(cfg.semantic,
                                torch.Generator().manual_seed(7))
    nets = [inference.load_model(tree, cfg.semantic, "cpu")
            for _ in range(2)]
    scans, _gt = render_plaza(1, seed0=640)
    sin = driver.pad_scan(scans[0].points[scans[0].valid], cfg, "cpu")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        for net in nets + nets:
            out = inference.infer_own_labels(net, (sin.points, sin.valid),
                                              cfg)
    assert profiling.counters()["rangenet_replays"] == 2
    assert len(graphs._graphs) == 2
    want = inference.label_scan(nets[1], sin.points, sin.valid, cfg)
    assert all(torch.equal(g, w) for g, w in zip(out, want))
    kept = id(nets[1])
    del net, nets[0]
    gc.collect()
    assert [sig[2][1] for sig in graphs._graphs] == [kept]
    nets.clear()
    gc.collect()
    assert not graphs._graphs
