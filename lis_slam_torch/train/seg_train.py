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

`make_sharded_train_step` is the JAX package's dp x tp x space step over a
parallel/mesh.py mesh: batch items over 'data', the output channels of the
convolutions that mesh.shard_params_tp picks over 'model', the image width
over 'space' (models/rangenet.forward_sharded). The loss is the global
masked sum over the global max(sum(mask), 1); the gradients are summed
over 'data' and 'space'; Adam runs on each rank's slice, which is the
unsharded update (Adam is elementwise).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..config import SemanticConfig
from ..models import rangenet
from ..parallel import mesh as pmesh
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


class StateSharding:
    """Cuts a full model and its Adam state into this rank's shard, in
    place (`__call__`), and gathers them back (`gather`), after which
    load_jax_train_state and to_variables work on them. The BatchNorm
    running statistics stay whole on every rank."""

    def __init__(self, placements: dict[str, pmesh.Placement]):
        self.placements = placements

    def _each(self, model, opt, fn):
        for name, p in model.named_parameters():
            pl = self.placements[name]
            if not pl.dims:
                continue
            p.data = fn(pl, p.data)
            for key in ("exp_avg", "exp_avg_sq"):
                if key in opt.state.get(p, {}):
                    opt.state[p][key] = fn(pl, opt.state[p][key])

    def __call__(self, model: rangenet.RangeNet, opt: torch.optim.Adam):
        self._each(model, opt, lambda pl, x: pl(x).clone())
        return model, opt

    def gather(self, model: rangenet.RangeNet, opt: torch.optim.Adam):
        self._each(model, opt, lambda pl, x: pl.gather(x))
        return model, opt


def make_sharded_train_step(model: rangenet.RangeNet,
                            opt: torch.optim.Optimizer, mesh):
    """(step, shard_state, batch_sh) for the whole `model` (before
    shard_state cuts it) over `mesh`: step(images, labels, mask) takes
    this rank's blocks (mesh.shard_images / shard_planes of the global
    batch) and returns {"loss", "grad_norm"} of the global batch, the
    same on every rank; shard_state is a StateSharding; batch_sh the
    batch's placement over 'data'. Call it on every rank."""
    placements, sharded = pmesh.shard_params_tp(dict(model.state_dict()),
                                                mesh)
    data, mdl, space = (pmesh.axis(mesh, n) for n in ("data", "model",
                                                      "space"))
    split = [bool(placements[n].dims) for n, _ in model.named_parameters()]

    def train_step(images, labels, mask):
        params = list(model.parameters())
        opt.zero_grad(set_to_none=True)
        logp = F.log_softmax(
            rangenet.forward_sharded(model, images, mesh, sharded), dim=-1)
        ce = -torch.gather(logp, -1, labels.long()[..., None])[..., 0]
        total = torch.where(mask, ce, torch.zeros_like(ce)).sum()
        count = torch.clamp(pmesh.all_reduce(mask.sum(), data, space),
                            min=1)
        (total / count).backward()
        grads = [p.grad for p in params]
        flat = pmesh.all_reduce(torch.cat([g.reshape(-1) for g in grads]),
                                data, space)
        for g, part in zip(grads, flat.split([g.numel() for g in grads])):
            g.copy_(part.view_as(g))
        sq = torch.stack(torch._foreach_norm(grads)) ** 2
        on = torch.tensor(split, dtype=sq.dtype, device=sq.device)
        grad_norm = torch.sqrt(pmesh.all_reduce((sq * on).sum(), mdl)
                               + (sq * (1 - on)).sum())
        loss = pmesh.all_reduce(total.detach().clone(), data, space) / count
        opt.step()
        return {"loss": loss, "grad_norm": grad_norm}

    return train_step, StateSharding(placements), pmesh.shard_batch(mesh)


def train_sharded(rank: int, world_mesh, cfg: SemanticConfig,
                  variables: dict, images, labels, mask, lr: float = 1e-3,
                  steps: int = 1, model_parallel: int = 1,
                  spatial_parallel: int = 1) -> dict:
    """One rank of `steps` sharded training steps (a parallel/mesh.spawn
    function): the model from the flax-layout `variables` on
    make_mesh(world, model_parallel, spatial_parallel), fed this rank's
    blocks of the global batch (numpy or CPU tensors). Returns, the same
    on every rank: the losses and grad norms, each step's ms (CUDA events
    on a card, else the host clock), the last step's gradients (whole,
    keyed as the state_dict), the trained variables (whole, flax layout)
    and every rank's peak device memory (0 on the CPU)."""
    import time

    dev_type = world_mesh.device_type
    device = torch.device("cuda", torch.cuda.current_device()) \
        if dev_type == "cuda" else torch.device("cpu")
    mesh = pmesh.make_mesh(None, model_parallel, spatial_parallel,
                           device=dev_type)
    model, opt = create_train_state(cfg, None, lr=lr, device=device,
                                    variables=variables)
    step, shard_state, _ = make_sharded_train_step(model, opt, mesh)
    shard_state(model, opt)
    img_sh, pl_sh = pmesh.shard_images(mesh), pmesh.shard_planes(mesh)
    x = img_sh(torch.as_tensor(images)).to(device)
    y = pl_sh(torch.as_tensor(labels)).to(device)
    m = pl_sh(torch.as_tensor(mask)).to(device)
    if dev_type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    losses, norms, ms = [], [], []
    for _ in range(steps):
        if dev_type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = step(x, y, m)
            end.record()
            torch.cuda.synchronize()
            ms.append(start.elapsed_time(end))
        else:
            t = time.perf_counter()
            out = step(x, y, m)
            ms.append(1e3 * (time.perf_counter() - t))
        losses.append(float(out["loss"]))
        norms.append(float(out["grad_norm"]))
    peaks = [None] * world_mesh.size()
    torch.distributed.all_gather_object(
        peaks, torch.cuda.max_memory_allocated() if dev_type == "cuda" else 0)
    grads = {n: shard_state.placements[n].gather(p.grad).cpu()
             for n, p in model.named_parameters()}
    shard_state.gather(model, opt)
    return {"losses": losses, "grad_norms": norms, "step_ms": ms,
            "grads": grads, "variables": to_variables(model, cfg),
            "peak_bytes": peaks}
