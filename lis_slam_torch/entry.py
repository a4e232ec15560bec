"""The port's entry points (counterpart of the JAX package's
__graft_entry__.py, which stays the JAX package's).

`entry()` returns the flagship per-scan odometry step on the KITTI HDL-64
configuration and example arguments. `dryrun_multichip(n)` starts n ranks
(parallel/mesh.spawn) and runs on them one sharded RangeNet training step
(dp x tp x space) on tiny shapes, then the full uniform odometry step over
n lanes sharded over the mesh, two steps, the second on a populated map.
The ranks are processes, so the JAX re-exec with a virtual device count
has no counterpart here.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .config import SemanticConfig, SensorConfig, SlamConfig
from .parallel import batched
from .parallel import mesh as pmesh
from .pipeline import odometry
from .train import seg_train
from .utils import device as devices


def entry(device: torch.device | str = "cuda"):
    """(fn, (state, scan)): odometry.odom_step on the default SlamConfig
    with 64 x 1800 raw points, and a first state and a scan of seeded
    uniform points in [-30, 30) m. The port's step does not donate its
    state, so `fn` may run repeatedly from the same example state."""
    device = devices.resolve(device)
    cfg = SlamConfig().replace(sensor=SensorConfig(max_raw_points=64 * 1800))
    state = odometry.init_state(cfg, device)
    pts = np.random.default_rng(0).uniform(-30, 30, (64 * 1800, 4))
    scan = odometry.ScanInput(
        points=torch.as_tensor(pts, dtype=torch.float32, device=device),
        valid=torch.ones(64 * 1800, dtype=torch.bool, device=device))

    def fn(state, scan):
        return odometry.odom_step(state, scan, cfg)

    return fn, (state, scan)


def _small_slam_config() -> SlamConfig:
    """The JAX dryrun's shrunk capacities (__graft_entry__.py:152-164):
    the program is the full step, at sizes a CPU mesh runs quickly."""
    base = SlamConfig()
    return base.replace(
        sensor=SensorConfig(
            n_scan=16, horizon_scan=180, downsample_rate=1,
            lidar_min_range=1.0, lidar_max_range=60.0, max_raw_points=2048),
        feature=dataclasses.replace(
            base.feature, max_corner_points=256, max_surf_points=1024,
            max_sharp_corner_points=128, max_sharp_surf_points=256),
        matching=dataclasses.replace(
            base.matching, corner_map_capacity=1024, surf_map_capacity=4096,
            hash_table_slots=1 << 10, min_valid_points=10))


def _dryrun_rank(rank: int, world_mesh, semantic: SemanticConfig | None):
    n = world_mesh.size()
    dev_type = world_mesh.device_type
    device = torch.device("cuda", torch.cuda.current_device()) \
        if dev_type == "cuda" else torch.device("cpu")
    model_parallel = 2 if n % 2 == 0 else 1
    spatial = 2 if n % (model_parallel * 2) == 0 else 1
    mesh = pmesh.make_mesh(n, model_parallel=model_parallel,
                           spatial_parallel=spatial, device=dev_type)

    # one sharded training step on tiny shapes (dp x tp x space)
    cfg = semantic or SemanticConfig(model_input_h=64, model_input_w=64,
                                     fp16=True)
    model, opt = seg_train.create_train_state(
        cfg, torch.Generator().manual_seed(0), device=device)
    step, shard_state, _ = seg_train.make_sharded_train_step(model, opt,
                                                             mesh)
    shard_state(model, opt)
    shape = (n // (model_parallel * spatial), 64, 64)
    img_sh, pl_sh = pmesh.shard_images(mesh), pmesh.shard_planes(mesh)
    images = img_sh(torch.zeros(shape + (5,), device=device))
    labels = pl_sh(torch.zeros(shape, dtype=torch.int32, device=device))
    mask = pl_sh(torch.ones(shape, dtype=torch.bool, device=device))
    loss = float(step(images, labels, mask)["loss"])
    if not np.isfinite(loss):
        raise RuntimeError(f"dryrun: sharded training loss {loss}")
    del model, opt, step

    # the full uniform odometry step over n lanes sharded over 'data'
    small = _small_slam_config()
    seq_mesh = pmesh.make_mesh(n, model_parallel=1, device=dev_type)
    ostep, shard, lanes = batched.make_sharded_step(small, seq_mesh)
    states = shard(batched.batched_init_state(small, n, device))
    r = np.random.default_rng(0)
    p_cap = small.sensor.max_raw_points
    scans = shard(odometry.ScanInput(
        points=torch.as_tensor(r.uniform(-30, 30, (n, p_cap, 4)),
                               dtype=torch.float32, device=device),
        valid=torch.ones((n, p_cap), dtype=torch.bool, device=device),
        scan_start=torch.zeros(n, device=device),
        init_guess_valid=torch.zeros(n, dtype=torch.bool, device=device),
        imu_rpy_valid=torch.zeros(n, dtype=torch.bool, device=device),
        vel_valid=torch.zeros(n, dtype=torch.bool, device=device)))
    for _ in range(2):  # the second step runs on a populated map
        states, outs = ostep(states, scans)
    poses = lanes.gather(outs.pose).cpu().numpy()
    if poses.shape != (n, 6) or not np.all(np.isfinite(poses)):
        raise RuntimeError(f"dryrun: poses {poses.shape} not finite (n, 6)")
    return {"loss": loss, "poses": poses,
            "mesh": dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))}


def dryrun_multichip(n: int, device: torch.device | str = "cuda",
                     backend: str | None = None,
                     semantic: SemanticConfig | None = None) -> dict:
    """The JAX dryrun (__graft_entry__.py:101-186) on n ranks: a (data,
    model 2 if n is even, space 2 if 4 divides n) mesh for one fp16
    training step at 64 x 64, batch n / (model x space), from seeded
    weights (`semantic`: another architecture, e.g. slim widths on a
    CPU); then odom_step_uniform over n lanes of seeded uniform points
    sharded over a 'data'-only mesh, two steps. Raises unless the loss
    and the (n, 6) poses are finite; returns them and the mesh's shape.
    `backend`: parallel/mesh.spawn's."""
    dev = devices.resolve(device)
    return pmesh.spawn(n, _dryrun_rank, semantic, backend=backend,
                       device=dev)
