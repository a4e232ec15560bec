"""RangeNet semantic-segmentation training step (port of
lis_slam_tpu/train/seg_train.py; the reference ships only a pretrained
TensorRT engine and no training code).

Masked softmax cross-entropy over the spherical range image, averaged over
max(sum(mask), 1); Adam with optax.adam's defaults (b1 0.9, b2 0.999,
eps 1e-8); float32 parameters, convolutions in the compute dtype (bf16
when cfg.fp16), BatchNorm in float32 with flax's train-mode statistics
(models/rangenet.py). The metrics are the loss and the gradient's global
L2 norm. The convolutions are cuDNN calls: the JAX package has no Pallas
kernel on RangeNet.

Weights cross both ways: `load_jax_train_state` puts a JAX TrainState's
params, batch_stats and Adam moments into the port's model and optimizer,
and `to_variables` gives the trained model as the flax-layout tree that
`SemanticSlam(rangenet_params=...)` (either package's) takes.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..config import SemanticConfig
from ..models import rangenet
from ..semantic import weights as W
from ..utils import device as devices


def create_train_state(cfg: SemanticConfig, generator: torch.Generator,
                       lr: float = 1e-3, device: torch.device | str = "cuda",
                       variables: dict | None = None):
    """(model, optimizer): RangeNet(cfg) in train mode with float32
    parameters on `device`, holding `variables` (a flax-layout tree) or
    weights drawn by rangenet.init_params from `generator`; Adam(lr)."""
    device = devices.resolve(device)
    if variables is None:
        variables = rangenet.init_params(cfg, generator)
    model = rangenet.create_model(cfg, param_dtype=torch.float32)
    model.load_state_dict(W.to_torch_state(variables, cfg))
    model = model.to(device).train()
    opt = torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999),
                           eps=1e-8)
    return model, opt


def loss_fn(model: rangenet.RangeNet, images: torch.Tensor,
            labels: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Masked softmax cross-entropy: images (B, H, W, C), labels (B, H, W)
    class ids, mask (B, H, W) bool. In train mode the forward also moves
    the BatchNorm running statistics."""
    logp = F.log_softmax(model(images), dim=-1)
    ce = -torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    ce = torch.where(mask, ce, torch.zeros_like(ce))
    return ce.sum() / torch.clamp(mask.sum(), min=1)


def make_train_step(model: rangenet.RangeNet, opt: torch.optim.Optimizer):
    """Returns train_step(images, labels, mask) -> {"loss", "grad_norm"}
    (device scalars): one Adam step on the masked cross-entropy."""
    params = list(model.parameters())

    def train_step(images, labels, mask):
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(model, images, labels, mask)
        loss.backward()
        grad_norm = torch.linalg.vector_norm(torch.stack(
            torch._foreach_norm([p.grad for p in params])))
        opt.step()
        return {"loss": loss.detach(), "grad_norm": grad_norm}

    return train_step


def load_jax_train_state(model: rangenet.RangeNet, opt: torch.optim.Adam,
                         cfg: SemanticConfig, params: dict, batch_stats: dict,
                         mu: dict, nu: dict, count: int) -> None:
    """A JAX TrainState (its params and batch_stats, and optax's Adam
    state mu / nu / count, as numpy trees) into the port's model and
    optimizer; the moments take the parameters' layout (transposed, the
    transposed-conv kernel flipped)."""
    model.load_state_dict(W.to_torch_state(
        {"params": params, "batch_stats": batch_stats}, cfg))
    m = W.to_torch_state({"params": mu, "batch_stats": batch_stats}, cfg)
    v = W.to_torch_state({"params": nu, "batch_stats": batch_stats}, cfg)
    for name, p in model.named_parameters():
        opt.state[p] = {"step": torch.tensor(float(count)),
                        "exp_avg": m[name].to(p),
                        "exp_avg_sq": v[name].to(p)}


def to_variables(model: rangenet.RangeNet, cfg: SemanticConfig) -> dict:
    """The model's weights and running statistics as a flax-layout tree
    ({'params', 'batch_stats'}, numpy float32)."""
    return W.from_torch_state(model.state_dict(), cfg)
