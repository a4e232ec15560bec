"""The synthetic-world RangeNet training recipe (port of the JAX package's
scripts/train_rangenet_synthetic.py, which made the in-repo slim
checkpoint weights/rangenet_synthetic_slim.npz).

Labelled HDL-64 scans of several procedural worlds (io/synthetic_torch,
rendered on the device) are projected with their labels carried through
`project`'s rel_time channel, normalized into RangeNet's 5-channel image
and padded to H_PAD columns. The slim RangeNet (config.
slim_semantic_config: bf16 compute, float32 parameters) trains on random
CROP_W-wide crops with Adam under a warm-up + cosine schedule and a global
norm clip at 1.0 (seg_train.recipe_train_step), and is scored by the mean
IoU of a full-width eval-mode pass over the last N_VAL images.

As in the JAX script the sensor is SlamConfig().sensor, whose
downsample_rate of 2 keeps the even rings only: the odd rows of every
training image are empty.

    python scripts/train_rangenet_synthetic_torch.py --steps 2500
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import SemanticConfig, SensorConfig, SlamConfig
from ..config import slim_semantic_config
from ..io import synthetic, synthetic_torch
from ..models import rangenet
from ..ops import pretreatment, projection
from ..utils import device as devices
from . import seg_train

H_PAD = 1824  # 1800 padded to a multiple of 32 (the OS-32 encoder)
CROP_W = 512
N_VAL = 10  # held-out images, the dataset's last
NOISE_SEED = 7  # the renderer's noise generator (the JAX script's PRNGKey)
VIEW_SEED = 123  # the viewpoints' numpy generator
CROP_SEED = 0  # the crops' numpy generator
INIT_SEED = 0  # the initial weights' torch generator
LOG_EVERY = 100  # steps between the losses kept


class Dataset(NamedTuple):
    """Labelled images on one device, the held-out ones last."""

    images: torch.Tensor  # (n, 64, H_PAD, 5) float16
    labels: torch.Tensor  # (n, 64, H_PAD) int8
    masks: torch.Tensor  # (n, 64, H_PAD) bool


class TrainResult(NamedTuple):
    variables: dict  # flax-layout tree (numpy float32)
    miou: float  # held-out mean IoU over the classes present
    per_class: dict  # class id -> IoU
    losses: dict  # step -> loss, every LOG_EVERY steps and the last
    seconds: float  # the training loop's wall time, device synced


def make_image(points: torch.Tensor, labels: torch.Tensor,
               valid: torch.Tensor, sensor_cfg: SensorConfig,
               sem_cfg: SemanticConfig):
    """One raw scan ((P, 4) points, (P,) labels, (P,) valid) as RangeNet's
    input image (N_SCAN, H, 5) and its per-pixel labels (int8, 0 where the
    pixel is empty) and mask: the labels ride `project`'s rel_time
    channel and are rounded back."""
    pre = pretreatment.pretreat(points, valid, sensor_cfg)
    img = projection.project(pre.points[:, :3], pre.points[:, 3], pre.ring,
                             labels.to(torch.float32), pre.valid, sensor_cfg)
    x = rangenet.build_input_image(img.rng, img.xyz, img.intensity,
                                   img.mask, sem_cfg)
    lab = torch.round(img.time).to(torch.int8)
    return x, torch.where(img.mask, lab, torch.zeros_like(lab)), img.mask


def _viewpoints(n: int) -> np.ndarray:
    """(n, 6) random street-level poses (roll, pitch, yaw, x, y, z) from
    the VIEW_SEED generator, in the JAX script's order of draws."""
    rng = np.random.default_rng(VIEW_SEED)
    return np.array([[0.0, 0.0, rng.uniform(0, 2 * np.pi),
                      rng.uniform(-80, 80), rng.uniform(-80, 80),
                      rng.uniform(1.4, 2.2)] for _ in range(n)], np.float32)


def render_dataset(n_worlds: int = 4, scans_per_world: int = 22,
                   seed0: int = 0,
                   generator: torch.Generator | None = None,
                   device: torch.device | str = "cuda") -> Dataset:
    """Labelled images of `scans_per_world` viewpoints in each of the
    worlds make_world(seed0 + i), rendered and projected on `device` and
    kept there (~0.1 GB for the default 88). The renderer's noise comes
    from `generator` (a NOISE_SEED generator on `device` if None)."""
    device = devices.resolve(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(NOISE_SEED)
    sensor, sem = SlamConfig().sensor, slim_semantic_config()
    poses = torch.as_tensor(_viewpoints(n_worlds * scans_per_world),
                            device=device)
    imgs, labs, masks = [], [], []
    for wi in range(n_worlds):
        world = synthetic_torch.to_device_world(
            synthetic.make_world(seed0 + wi), device)
        for si in range(scans_per_world):
            pts, lbl, val = synthetic_torch.render_scan_device(
                world, poses[wi * scans_per_world + si], generator)
            x, lab, m = make_image(pts, lbl, val, sensor, sem)
            pad = H_PAD - x.shape[1]
            imgs.append(F.pad(x.to(torch.float16), (0, 0, 0, pad)))
            labs.append(F.pad(lab, (0, pad)))
            masks.append(F.pad(m, (0, pad)))
    return Dataset(torch.stack(imgs), torch.stack(labs), torch.stack(masks))


def miou(logits_argmax: np.ndarray, labels: np.ndarray, mask: np.ndarray):
    """Mean IoU over the classes present in the ground truth (class 0
    excluded), and the per-class IoUs."""
    present = np.unique(labels[mask])
    present = present[present > 0]
    ious = []
    for c in present:
        pred_c = (logits_argmax == c) & mask
        gt_c = (labels == c) & mask
        inter = np.sum(pred_c & gt_c)
        union = np.sum(pred_c | gt_c)
        if union > 0:
            ious.append(inter / union)
    return float(np.mean(ious)), {int(c): float(i)
                                  for c, i in zip(present, ious)}


def _crops(steps: int, batch: int, n_train: int):
    """(image index, column offset) of each crop, (steps, batch) each,
    drawn from the CROP_SEED generator in the JAX script's order."""
    rng = np.random.default_rng(CROP_SEED)
    si, off = np.empty((2, steps, batch), np.int64)
    for it in range(steps):
        si[it] = rng.integers(0, n_train, batch)
        off[it] = rng.integers(0, H_PAD - CROP_W, batch)
    return si, off


def train(steps: int, batch: int = 8, lr: float = 2e-3,
          data: Dataset | None = None, device: torch.device | str = "cuda",
          log=None) -> TrainResult:
    """Train the slim RangeNet for `steps` recipe steps on `data` (rendered
    by render_dataset on `device` if None) from weights drawn with a CPU
    generator seeded INIT_SEED, and score it on the held-out images.
    `log(step, loss, seconds)` is called every LOG_EVERY steps and at the
    last."""
    device = devices.resolve(device)
    if data is None:
        data = render_dataset(device=device)
    images, labels, masks = (t.to(device) for t in data)
    n_train = images.shape[0] - N_VAL
    sem = slim_semantic_config()
    model, opt = seg_train.create_train_state(
        sem, torch.Generator().manual_seed(INIT_SEED), lr=lr, device=device)
    step = seg_train.recipe_train_step(model, opt, steps, lr)
    si, off = (torch.as_tensor(a, device=device)
               for a in _crops(steps, batch, n_train))
    cols = torch.arange(CROP_W, device=device)
    rows = torch.arange(images.shape[1], device=device)[None, :, None]
    losses = {}
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    for it in range(steps):
        idx = si[it][:, None, None]
        col = (off[it][:, None] + cols)[:, None, :]
        metrics = step(images[idx, rows, col].to(torch.float32),
                       labels[idx, rows, col].to(torch.int32),
                       masks[idx, rows, col])
        if it % LOG_EVERY == 0 or it == steps - 1:
            losses[it] = float(metrics["loss"])
            if log is not None:
                log(it, losses[it], time.perf_counter() - t0)
    sync()
    seconds = time.perf_counter() - t0

    model.eval()
    with torch.no_grad():
        preds = torch.cat([
            model(images[i:i + 1].to(torch.float32)).argmax(-1)
            for i in range(n_train, images.shape[0])])
    m, per_class = miou(preds.cpu().numpy(), labels[n_train:].cpu().numpy(),
                        masks[n_train:].cpu().numpy())
    return TrainResult(seg_train.to_variables(model, sem), m, per_class,
                       losses, seconds)
