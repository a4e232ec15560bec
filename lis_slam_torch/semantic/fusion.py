"""Semantic fusion: RangeNet inference -> per-pixel labels -> category and
matching-weight images (port of lis_slam_tpu/semantic/fusion.py).

Rebuild of `RangenetAPI::infer` (reference src/core/rangenetAPI.cpp:17-127,
per-pixel argmax over 20 classes, label colours), the 20 -> 5
super-category mapping of `SemanticFusionNode::categoryMapping`
(src/node/semanticFusionNode.cpp:139-254), and the matching weights w = 2 -
LabelSorce[label] (subMapOptmizationNode.cpp:1671,1795).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import labels as L
from ..config import SemanticConfig
from ..models import rangenet


class SemanticImage(NamedTuple):
    labels: torch.Tensor  # (N, H) int32 learning-class id (argmax)
    category: torch.Tensor  # (N, H) int32 dense category index 0..4, -1 invalid
    weight: torch.Tensor  # (N, H) float32 residual weight w = 2 - score
    probs_max: torch.Tensor  # (N, H) max softmax prob (confidence)


def infer_labels(model: rangenet.RangeNet, rng_img, xyz_img, intensity_img,
                 mask, cfg: SemanticConfig) -> SemanticImage:
    """Run the net on the projected scan and derive the label and weight
    images. The OS-32 encoder needs the width divisible by 32 (RangeNet++
    trains at 2048): other widths (e.g. 1800) are zero-padded on the right
    and the logits cropped. Argmax in float32, the first class on ties."""
    img = rangenet.build_input_image(rng_img, xyz_img, intensity_img, mask,
                                     cfg)
    w = img.shape[1]
    pad = (-w) % 32
    if pad:
        img = torch.nn.functional.pad(img, (0, 0, 0, pad))
    with torch.no_grad():
        logits = model(img[None])[0]
    probs = logits[:, :w].float()
    lab = torch.argmax(probs, dim=-1).to(torch.int32)
    pmax = torch.max(torch.softmax(probs, dim=-1), dim=-1).values
    lab = torch.where(mask, lab, torch.zeros_like(lab))
    return label_images(lab, mask, pmax)


def label_images(lab: torch.Tensor, mask: torch.Tensor,
                 pmax: torch.Tensor | None = None) -> SemanticImage:
    """Category and weight images from a label image (also used with
    ground-truth labels)."""
    dev = lab.device
    cat_lut = torch.as_tensor(L.LEARNING_TO_CATEGORY, device=dev)
    w_lut = torch.as_tensor(L.RESIDUAL_WEIGHT, device=dev)
    idx = lab.long()
    cat = torch.where(mask, cat_lut[idx].to(torch.int32),
                      torch.full_like(lab, -1, dtype=torch.int32))
    w = torch.where(mask, w_lut[idx].to(torch.float32),
                    torch.ones_like(lab, dtype=torch.float32))
    if pmax is None:
        pmax = mask.to(torch.float32)
    return SemanticImage(labels=lab, category=cat, weight=w, probs_max=pmax)


def category_mask(sem: SemanticImage, category_index: int) -> torch.Tensor:
    """Boolean (N, H) mask of one super-category (categoryMapping)."""
    return sem.category == category_index


def labels_to_rgb(lab: np.ndarray) -> np.ndarray:
    """Learning-class ids -> RGB uint8 (Argmax2RGB, rangenetAPI.cpp:75-127)."""
    return L.LEARNING_RGB[np.clip(lab, 0, L.NUM_LEARNING_CLASSES - 1)]


def dynamic_mask(sem: SemanticImage) -> torch.Tensor:
    """Pixels of the dynamic super-class (candidates for map-based removal,
    subMap.h:1065-1100)."""
    dyn_idx = int(np.where(L.CATEGORY_IDS == L.CAT_DYNAMIC)[0][0])
    return sem.category == dyn_idx
