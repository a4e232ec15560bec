"""Device mesh over torch.distributed (port of
lis_slam_tpu/parallel/mesh.py): the mesh, the placements of batches,
images and parameters, and a launcher that starts one process per rank.

The JAX package names shardings and lets XLA GSPMD insert the
collectives. Here every rank is a process that holds only its block of
each sharded tensor, and the sharded programs (parallel/batched.py's
lane-sharded odometry step, models/rangenet.py's sharded forward,
train/seg_train.py's sharded training step) call the collectives
themselves, over the mesh's per-axis process groups:

 - 'data': batch items (images, odometry lanes), contiguous blocks in rank
   order, as P("data");
 - 'model': output channels of the RangeNet convolutions that
   `shard_params_tp` picks (tensor parallelism);
 - 'space': the image width (each rank a contiguous block of columns, the
   convolutions exchanging halo columns with their neighbours).

The sharded programs use two collectives only, all_reduce and all_gather
(`all_gather` below), which NCCL runs and gloo runs on CPU and CUDA
tensors alike; so two ranks sharing one card over gloo execute the code a
multi-card NCCL run executes.
"""

from __future__ import annotations

import os
import tempfile
from typing import Callable, NamedTuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def make_mesh(n_devices: int | None = None, model_parallel: int = 1,
              spatial_parallel: int = 1,
              device: torch.device | str = "cuda") -> DeviceMesh:
    """A DeviceMesh over the process group's ranks with dims ("data",
    "model"), or ("data", "model", "space") when spatial_parallel > 1,
    laid out row-major as the JAX mesh: rank r = ((d mp) + m) sp + s.
    `n_devices` must equal the world size (a process group cannot be cut
    to its first n ranks as jax.devices()[:n] is); model_parallel x
    spatial_parallel must divide it. The default process group must be
    initialized (`spawn` does)."""
    world = dist.get_world_size()
    n = n_devices or world
    if n != world:
        raise ValueError(f"make_mesh: n_devices {n} != world size {world}")
    assert n % (model_parallel * spatial_parallel) == 0, (
        n, model_parallel, spatial_parallel)
    dev = torch.device(device).type
    if spatial_parallel > 1:
        return init_device_mesh(
            dev, (n // (model_parallel * spatial_parallel), model_parallel,
                  spatial_parallel), mesh_dim_names=("data", "model", "space"))
    return init_device_mesh(dev, (n // model_parallel, model_parallel),
                            mesh_dim_names=("data", "model"))


class Axis(NamedTuple):
    """One mesh dim as this rank sees it: its process group (None when
    the dim has one rank or the mesh lacks it), size and coordinate."""
    group: dist.ProcessGroup | None
    size: int
    index: int


def axis(mesh: DeviceMesh | None, name: str) -> Axis:
    """The mesh dim `name` as this rank sees it; mesh None is the world of
    one process with no process group (every dim of size 1)."""
    if mesh is None or name not in (mesh.mesh_dim_names or ()):
        return Axis(None, 1, 0)
    size = mesh.size(mesh.mesh_dim_names.index(name))
    if size == 1:
        return Axis(None, 1, 0)
    return Axis(mesh.get_group(name), size, mesh.get_local_rank(name))


def all_gather(x: torch.Tensor, ax: Axis) -> list[torch.Tensor]:
    """Every rank's `x` along the mesh dim `ax`, in coordinate order (all
    blocks have x's shape). Not differentiable: models/rangenet.py wraps
    it where a gradient crosses ranks."""
    if ax.group is None:
        return [x]
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(ax.size)]
    dist.all_gather(parts, x, group=ax.group)
    return parts


def all_reduce(x: torch.Tensor, *axes: Axis) -> torch.Tensor:
    """`x` summed over the mesh dims `axes` (in place, returned)."""
    for ax in axes:
        if ax.group is not None:
            dist.all_reduce(x, group=ax.group)
    return x


class Placement(NamedTuple):
    """Where the blocks of a tensor live: tensor dim -> mesh dim name, for
    each sharded dim (none: replicated). Calling it on a full tensor gives
    this rank's block; `gather` puts the blocks back together."""
    mesh: DeviceMesh
    dims: tuple[tuple[int, str], ...] = ()

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        for dim, name in self.dims:
            ax = axis(self.mesh, name)
            n = x.shape[dim]
            if n % ax.size:
                raise ValueError(f"dim {dim} of size {n} does not split "
                                 f"over {ax.size} '{name}' ranks")
            x = x.narrow(dim, ax.index * (n // ax.size), n // ax.size)
        return x

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        for dim, name in reversed(self.dims):
            x = torch.cat(all_gather(x, axis(self.mesh, name)), dim=dim)
        return x


def _on(mesh: DeviceMesh | None, **dims: int) -> Placement:
    """A placement over the named mesh dims that the mesh has."""
    names = (mesh.mesh_dim_names or ()) if mesh is not None else ()
    return Placement(mesh, tuple((d, n) for n, d in dims.items()
                                 if n in names))


def shard_batch(mesh: DeviceMesh) -> Placement:
    """Batch tensors: leading dim over 'data'."""
    return _on(mesh, data=0)


def shard_images(mesh: DeviceMesh) -> Placement:
    """(B, H, W, C) images: batch over 'data', width over 'space' when the
    mesh has it."""
    return _on(mesh, data=0, space=2)


def shard_planes(mesh: DeviceMesh) -> Placement:
    """(B, H, W) label and mask planes: companion of shard_images."""
    return _on(mesh, data=0, space=2)


def replicated(mesh: DeviceMesh) -> Placement:
    return Placement(mesh)


def shard_params_tp(state: dict[str, torch.Tensor], mesh: DeviceMesh
                    ) -> tuple[dict[str, Placement], list[str]]:
    """The JAX package's channel-parallel rule on a RangeNet state_dict:
    a 4-D kernel is split on its output channels over 'model' where
    cout % tp == 0 and cout >= 8 tp, a 1-D parameter by the same rule on
    its length; the BatchNorm running statistics (JAX's batch_stats) and
    everything else are replicated. Output channels are dim 0 of a Conv2d
    kernel (O, I, kH, kW) and dim 1 of a ConvTranspose2d kernel (I, O, kH,
    kW), the port's modules carrying flax's scope names. Returns each
    key's placement and the sorted keys it shards."""
    tp = axis(mesh, "model").size
    out, sharded = {}, []
    for key, x in state.items():
        dim = None
        if key.rsplit(".", 1)[-1] in ("weight", "bias"):
            if x.ndim == 4:
                dim = 1 if "ConvTranspose" in key else 0
            elif x.ndim == 1:
                dim = 0
        if dim is not None and x.shape[dim] % tp == 0 and \
                x.shape[dim] >= 8 * tp and tp > 1:
            out[key] = Placement(mesh, ((dim, "model"),))
            sharded.append(key)
        else:
            out[key] = Placement(mesh)
    return out, sorted(sharded)


def apply_sharding(tree, placement: Placement):
    """`placement` applied to every tensor of `tree`: a tensor, a
    NamedTuple, tuple, list or dict of tensors, None left as is."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return placement(tree)
    if isinstance(tree, dict):
        return {k: apply_sharding(v, placement) for k, v in tree.items()}
    items = [apply_sharding(v, placement) for v in tree]
    return type(tree)(*items) if hasattr(tree, "_fields") else \
        type(tree)(items)


def _run_rank(rank: int, world: int, fn: Callable, args: tuple,
              backend: str, device: str, tmp: str) -> None:
    if device == "cpu":
        # ranks share the host's cores: one thread each (bf16 training on
        # the CPU took 340 s against 1.5 s under thread contention)
        torch.set_num_threads(1)
    else:
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"file://{tmp}/rendezvous",
                            rank=rank, world_size=world)
    try:
        result = fn(rank, make_mesh(world, device=device), *args)
        if rank == 0:
            torch.save(result, os.path.join(tmp, "result.pt"))
    finally:
        dist.destroy_process_group()


def spawn(world: int, fn: Callable, *args, backend: str | None = None,
          device: torch.device | str = "cuda"):
    """Run fn(rank, mesh, *args) in `world` processes, `mesh` being
    make_mesh(world) (one 'data' dim: fn builds other layouts over the
    same world with make_mesh), and return rank 0's result. `fn` must be
    importable (a module-level function); the ranks meet at a file in a
    fresh temporary directory. On CUDA rank r takes card r % cards. The
    backend is the caller's: "nccl" by default on CUDA (a card a rank),
    "gloo" on the CPU; backend="gloo" with device="cuda" lets ranks share
    a card (NCCL refuses two ranks on one GPU). An exception in any rank
    stops the others and raises here with that rank's traceback."""
    dev = torch.device(device).type
    if backend is None:
        backend = "nccl" if dev == "cuda" else "gloo"
    if dev == "cuda" and backend == "nccl" and \
            torch.cuda.device_count() < world:
        raise RuntimeError(f"spawn: {world} ranks on nccl need {world} "
                           f"cards, found {torch.cuda.device_count()}")
    with tempfile.TemporaryDirectory(prefix="lis_mesh_") as tmp:
        torch.multiprocessing.spawn(
            _run_rank, (world, fn, args, backend, dev, tmp), nprocs=world,
            join=True)
        return torch.load(os.path.join(tmp, "result.pt"),
                          weights_only=False)
