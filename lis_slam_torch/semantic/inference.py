"""Per-scan semantic inference: raw cloud -> per-point learning-class labels
(port of lis_slam_tpu/semantic/inference.py).

The semanticFusionNode's inference path (src/node/semanticFusionNode.cpp:
139-170 -> rangenetAPI.cpp:17-127 -> netTensorRT.cpp:309-440): spherical
projection (the front end's, with its range image), RangeNet forward pass,
argmax, and unprojection back to the raw points by (ring, col) pixel.

`SemanticSlam` labels a keyframe from the front end's own projection
(`infer_winner_labels`); `infer_scan_labels` projects a raw scan itself.
"""

from __future__ import annotations

import torch

from ..config import SemanticConfig, SlamConfig
from ..models import rangenet
from ..ops import pretreatment, projection
from ..utils import device as devices
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
    The architecture comes from the checkpoint, the sensor grid from
    `cfg`."""

    def __init__(self, cfg: SlamConfig, checkpoint: str | None = None,
                 device: torch.device | str = "cuda"):
        sem_cfg, variables = W.load_checkpoint(checkpoint)
        self.cfg = cfg.replace(semantic=sem_cfg)
        self.model = load_model(variables, sem_cfg, device)

    def __call__(self, scan_points: torch.Tensor, scan_valid: torch.Tensor):
        return infer_scan_labels(self.model, scan_points, scan_valid,
                                 self.cfg)
