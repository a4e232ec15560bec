"""Batched multi-sequence odometry replay (port of
lis_slam_tpu/parallel/batched.py: `batched_init_state`,
`batched_odom_step`, `replay_batched`).

B sequences replay at once through one step over a leading lane dim: the
cond-free uniform step (pipeline/odometry._odom_step_lanes), whose every
operation takes all lanes in one launch, so a batched step launches as
many kernels at B = 32 as at B = 1 and never waits on the device. Where
the JAX package vmaps the step and must force the op-by-op GN path (a
Pallas call does not batch under vmap), the lanes here follow
cfg.matching.gn_backend: K2 and K3 take every lane in one launch.

`make_sharded_step` shards the lanes over a parallel/mesh.py mesh's 'data'
dim, as the JAX package's NamedSharding(mesh, P("data")): each rank steps
its contiguous block of lanes through the same batched_odom_step (K1, K2
and K3 inside), replicated over 'model'. Lanes are independent, so a step
has no collective; `replay_batched(mesh=...)` gathers every lane's poses
once, after the last scan.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import SlamConfig
from ..pipeline import driver, odometry
from ..utils import device as devices, profiling
from . import mesh as pmesh


def batched_init_state(cfg: SlamConfig, batch: int,
                       device: torch.device | str = "cuda"
                       ) -> odometry.OdomState:
    """`batch` fresh odometry states stacked on a leading lane dim."""
    one = odometry.init_state(cfg, device)
    return odometry.OdomState(*(t.expand((batch,) + t.shape).clone()
                                for t in one))


def stack_scans(scans: list) -> odometry.ScanInput:
    """Lanes of a ScanInput from one ScanInput per lane, all on one
    device: tensors stack on a new leading dim, the flags and scan_start
    become (B,) tensors, and a field that is None in every lane stays
    None (a field None in some lanes only raises)."""
    dev = scans[0].points.device
    fields = {}
    for name in odometry.ScanInput._fields:
        vals = [getattr(s, name) for s in scans]
        if all(v is None for v in vals):
            fields[name] = None
        elif any(v is None for v in vals):
            raise ValueError(f"stack_scans: {name} is None in some lanes")
        elif all(isinstance(v, torch.Tensor) for v in vals):
            fields[name] = torch.stack([v.to(dev) for v in vals])
        else:
            dtype = torch.bool if name.endswith("valid") else torch.float32
            fields[name] = torch.stack([torch.as_tensor(v, dtype=dtype)
                                        .to(dev) for v in vals])
    return odometry.ScanInput(**fields)


def batched_odom_step(states: odometry.OdomState,
                      scans: odometry.ScanInput, cfg: SlamConfig,
                      allow_kf: bool = True):
    """One uniform step for every lane: states and scans with a leading
    lane dim (stack_scans). Returns (states, OdomOutput with (B, ...)
    device tensors). Lane b's result is the single-sequence
    odometry.odom_step_uniform's on lane b's inputs, up to float32
    rounding. allow_kf=False leaves the keyframe merge out (the replay's
    host cadence, cfg.runtime.batched_kf_every)."""
    states, outs, _fc, _ext = odometry._odom_step_lanes(states, scans, cfg,
                                                        allow_kf)
    return states, outs


def _as_scan(scan, cfg: SlamConfig, device: torch.device):
    if isinstance(scan, odometry.ScanInput):
        return scan
    if hasattr(scan, "points"):  # a SyntheticScan-like host object
        return driver.pad_scan(scan.points[scan.valid], cfg, device)
    return driver.pad_scan(np.asarray(scan), cfg, device)


def make_sharded_step(cfg: SlamConfig, mesh):
    """(step, shard, seq_sharding) for lanes sharded over the mesh's
    'data' dim (replicated over 'model'): `shard(tree)` takes this rank's
    contiguous block of the lane dim of every tensor of an OdomState or
    ScanInput (None fields stay None), `step(states, scans,
    allow_kf=True)` is batched_odom_step on those lanes, and
    `seq_sharding` the lanes' mesh.Placement (its `gather` puts the lanes
    of every rank back together)."""
    seq_sharding = pmesh.shard_batch(mesh)

    def shard(tree):
        return pmesh.apply_sharding(tree, seq_sharding)

    def step(states, scans, allow_kf: bool = True):
        return batched_odom_step(states, scans, cfg, allow_kf=allow_kf)

    return step, shard, seq_sharding


def replay_batched(sequences, cfg: SlamConfig, mesh=None,
                   device: torch.device | str = "cuda") -> np.ndarray:
    """sequences: B lists of scans (each an odometry.ScanInput on `device`,
    a SyntheticScan-like host object with ``.points`` and ``.valid``, or a
    raw (P, 4) numpy cloud); the shortest sets the length N. Returns
    the poses (B, N, 6) as numpy. Keyframe merges run on the host cadence
    cfg.runtime.batched_kf_every (1 = every scan, exactly the uniform step;
    scan 0 always merges so the map is seeded). With a parallel/mesh.py
    `mesh` (called on every rank) each rank replays its block of the
    lanes (B must divide over 'data') and every rank returns all B lanes'
    poses, gathered once after the last scan.

    Spans (utils/profiling.py): root "replay_batched", per step
    "lane_upload" (pad and stack the lanes' scans) and "lane_step", and
    "gather"; the counter "scans" adds this rank's lanes a step. The step
    never waits on the device; the uploads of host clouds do (blocking
    copies: 7 waits a lane a step on an H100)."""
    device = devices.resolve(device)
    batch = len(sequences)
    n = min(len(s) for s in sequences)
    kf_every = max(1, cfg.runtime.batched_kf_every)
    step, _shard, lanes = make_sharded_step(cfg, mesh)
    data = pmesh.axis(mesh, "data")  # mesh None: all lanes here
    if batch % data.size:
        raise ValueError(f"replay_batched: {batch} lanes do not split over "
                         f"{data.size} 'data' ranks")
    per = batch // data.size
    sequences = sequences[data.index * per:(data.index + 1) * per]
    with profiling.root(profiling.StageTimer(), "replay_batched"):
        states = batched_init_state(cfg, per, device)
        poses = []
        for i in range(n):
            profiling.count("scans", per)
            with profiling.span("lane_upload"):
                scans = stack_scans([_as_scan(seq[i], cfg, device)
                                     for seq in sequences])
            with profiling.span("lane_step"):
                states, outs = step(states, scans,
                                    allow_kf=(i % kf_every == 0))
            poses.append(outs.pose)
        if not poses:
            return np.zeros((batch, 0, 6), np.float32)
        with profiling.span("gather"):
            return lanes.gather(torch.stack(poses, dim=1)).cpu().numpy()
