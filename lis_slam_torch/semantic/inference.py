"""Per-scan semantic inference: raw cloud -> per-point learning-class labels
(port of lis_slam_tpu/semantic/inference.py).

The semanticFusionNode's inference path (src/node/semanticFusionNode.cpp:
139-170 -> rangenetAPI.cpp:17-127 -> netTensorRT.cpp:309-440): spherical
projection (the front end's, with its range image), RangeNet forward pass,
argmax, and unprojection back to the raw points by (ring, col) pixel.

`SemanticSlam` labels a keyframe from the front end's own projection
(`infer_winner_labels`), or with cfg.semantic.own_projection from the
net's own (`infer_own_labels`); `infer_scan_labels` projects a raw scan
itself.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..config import SemanticConfig, SensorConfig, SlamConfig
from ..models import rangenet
from ..ops import pretreatment, projection
from ..utils import device as devices, graphs, profiling
from . import fusion
from . import weights as W


def infer_ext_image(model: rangenet.RangeNet,
                    ext: projection.ExtractedCloud,
                    cfg: SlamConfig) -> fusion.SemanticImage:
    """RangeNet's label images of the projected scan `ext` (its winners
    scattered back to the (N_SCAN, H) grid)."""
    img = projection.range_image(ext)
    return fusion.infer_labels(model, img.rng, img.xyz, img.intensity,
                               img.mask, cfg.semantic)


def infer_winner_labels(model: rangenet.RangeNet,
                        ext: projection.ExtractedCloud, n_points: int,
                        cfg: SlamConfig) -> torch.Tensor:
    """(n_points,) int32 labels of the raw points that won a pixel of
    `ext` (each at its raw index, `ext.src`), 0 for the rest. These are
    the only points whose labels the keyframe path reads (the semantic
    scan and the surf features are gathered by `src`), so the front end's
    projection serves RangeNet without a second pass."""
    sem = infer_ext_image(model, ext, cfg)
    h = ext.mask.shape[1]
    rows = torch.arange(ext.mask.shape[0], device=ext.mask.device)[:, None]
    pix = torch.where(ext.mask, rows * h + ext.col, torch.zeros_like(ext.col))
    dest = torch.where(ext.mask, ext.src, torch.full_like(ext.src, n_points))
    lab = torch.zeros(n_points + 1, dtype=torch.int32, device=ext.src.device)
    lab[dest.reshape(-1).long()] = sem.labels.reshape(-1)[
        pix.reshape(-1).long()]
    return lab[:n_points]


def infer_scan_labels(model: rangenet.RangeNet, points: torch.Tensor,
                      valid: torch.Tensor, cfg: SlamConfig):
    """points (P, 4) raw padded scan -> (labels (P,) int32, SemanticImage).

    Labels are learning-class ids per raw point (0 = unlabeled/invalid),
    read from the net's per-pixel argmax at each point's projected (ring,
    col) pixel: every point of a pixel takes its winner's label, which is
    the reference's unprojection for the points that survive its depth
    sort."""
    n, h = cfg.sensor.n_scan, cfg.sensor.horizon_scan
    pre = pretreatment.pretreat(points, valid, cfg.sensor)
    _img, ext = projection.project_and_extract(
        pre.points[:, :3], pre.points[:, 3], pre.ring, pre.rel_time,
        pre.valid, cfg.sensor)
    sem = infer_ext_image(model, ext, cfg)
    col = projection.pixel_columns(pre.points, h)
    ok = pre.valid & (pre.ring >= 0) & (pre.ring < n) & (col >= 0) & (col < h)
    pix = torch.where(ok, pre.ring * h + col, torch.zeros_like(col)).long()
    lab = torch.where(ok, sem.labels.reshape(-1)[pix],
                      torch.zeros_like(pix, dtype=torch.int32))
    return lab, sem


class KeyframeLabels(NamedTuple):
    """A keyframe labelled on the net's own projection (infer_own_labels)."""

    image: torch.Tensor  # (h, w, C) float32 normalized input, 0 where empty
    mask: torch.Tensor  # (h, w) bool, the pixels that hold a point
    logits: torch.Tensor  # (h, w, num_classes) float32
    labels: torch.Tensor  # (h, w) int32 argmax of the logits, 0 where empty
    point_labels: torch.Tensor  # (P,) int32 each point's pixel's, 0 off grid


def model_grid(cfg: SlamConfig) -> SensorConfig:
    """The sensor grid of the net's own projection: cfg.sensor at the
    net's model_input_h rows and model_input_w columns, every ring kept."""
    sem = cfg.semantic
    return dataclasses.replace(cfg.sensor, n_scan=sem.model_input_h,
                               horizon_scan=sem.model_input_w,
                               downsample_rate=1)


def label_pretreated(model: rangenet.RangeNet, points: torch.Tensor,
                     intensity: torch.Tensor, ring: torch.Tensor,
                     rel_time: torch.Tensor, valid: torch.Tensor,
                     cfg: SlamConfig) -> KeyframeLabels:
    """RangeNet's labels of pretreated points (xyz (P, 3), intensity,
    ring, rel_time, valid (P,)) on the net's own projection (model_grid):
    the port's projection (`project_and_extract`, the nearest point wins
    a pixel), the 5-channel image, the net, the argmax in float32 (the
    first class on ties), and each point's label read back at its (ring,
    column) pixel, as `infer_scan_labels` reads it.

    Against netTensorRT's doProjection (netTensorRT.cpp:143-300), as the
    repository's sources state it (SURVEY.md rows 11 and 13):
    - the reference keeps the nearest point of a pixel by a depth sort;
      here the nearest quantized range wins, the lower raw index on a tie;
    - a row is the ring id of the pretreatment (laserPretreatment.cpp:
      33-60: rings past 50 of an HDL-64 are dropped as outliers) and a
      column the front end's azimuth column (projectPointCloud); the
      sources do not record how doProjection picks either;
    - every ring is projected: downsample_rate thins the front end's
      grid, and the sources do not say whether the cloud the reference's
      node hands the net is thinned;
    - the reference unprojects per-point class probabilities and takes
      each point's argmax (rangenetAPI.cpp:60-73), which is its pixel's
      argmax, as here;
    - the convolutions run in bf16 where cfg.semantic.fp16, where the
      reference's engine runs float32 (fp16 disabled,
      netTensorRT.cpp:607)."""
    grid = model_grid(cfg)
    img, _ext = projection.project_and_extract(points, intensity, ring,
                                               rel_time, valid, grid,
                                               want_image=True)
    x = rangenet.build_input_image(img.rng, img.xyz, img.intensity,
                                   img.mask, cfg.semantic)
    with torch.no_grad():
        logits = model(x[None])[0].float()
    lab = torch.argmax(logits, dim=-1).to(torch.int32)
    lab = torch.where(img.mask, lab, torch.zeros_like(lab))
    h, w = grid.n_scan, grid.horizon_scan
    col = projection.pixel_columns(points, w)
    ok = valid & (ring >= 0) & (ring < h) & (col >= 0) & (col < w)
    pix = torch.where(ok, ring * w + col, torch.zeros_like(col)).long()
    point = torch.where(ok, lab.reshape(-1)[pix], torch.zeros_like(col))
    return KeyframeLabels(x, img.mask, logits, lab, point)


def label_scan(model: rangenet.RangeNet, points: torch.Tensor,
               valid: torch.Tensor, cfg: SlamConfig) -> KeyframeLabels:
    """label_pretreated of a padded raw scan (P, 4), pretreated as the
    front end pretreats it."""
    pre = pretreatment.pretreat(points, valid, cfg.sensor)
    return label_pretreated(model, pre.points[:, :3], pre.points[:, 3],
                            pre.ring, pre.rel_time, pre.valid, cfg)


def infer_own_labels(model: rangenet.RangeNet, inputs: tuple,
                     cfg: SlamConfig) -> KeyframeLabels:
    """A keyframe's labels on the net's own projection. `inputs`: the
    padded raw scan (points (P, 4), valid (P,)), which `label_scan`
    pretreats, or the front end's pretreated and deskewed points (xyz,
    intensity, ring, rel_time, valid), which `label_pretreated` reads.

    On the card the chain is one CUDA-graph replay (utils/graphs.py), a
    graph a signature (input shapes, cfg.sensor, cfg.semantic and the
    net), dropped when the net is freed; the first call of a signature
    runs eagerly and captures. While a profiler records, a replay counts
    `rangenet_replays` (utils/profiling.py)."""
    fn = label_scan if len(inputs) == 2 else label_pretreated
    out, replayed = graphs.replay(
        fn.__name__, lambda *a: fn(model, *a, cfg), tuple(inputs),
        (cfg.sensor, cfg.semantic), owner=model)
    if replayed:
        profiling.count("rangenet_replays")
    return out


def load_model(variables: dict, cfg: SemanticConfig,
               device: torch.device | str) -> rangenet.RangeNet:
    """The RangeNet of `cfg` on `device`, holding the flax-layout tree
    `variables` (weights.to_torch_state)."""
    device = devices.resolve(device)
    model = rangenet.create_model(cfg)
    model.load_state_dict(W.to_torch_state(variables, cfg))
    return model.to(device)


class SemanticInference:
    """Holds the model; loads the in-repo synthetic checkpoint by default.
    The architecture comes from the checkpoint; the sensor grid, and the
    net's own grid and whether it is used, from `cfg`."""

    def __init__(self, cfg: SlamConfig, checkpoint: str | None = None,
                 device: torch.device | str = "cuda"):
        sem_cfg, variables = W.load_checkpoint(checkpoint)
        sem = cfg.semantic  # the JAX package's config lacks own_projection
        sem_cfg = dataclasses.replace(
            sem_cfg, model_input_h=sem.model_input_h,
            model_input_w=sem.model_input_w,
            own_projection=getattr(sem, "own_projection", False))
        self.cfg = cfg.replace(semantic=sem_cfg)
        self.model = load_model(variables, sem_cfg, device)

    def __call__(self, scan_points: torch.Tensor, scan_valid: torch.Tensor):
        return infer_scan_labels(self.model, scan_points, scan_valid,
                                 self.cfg)
