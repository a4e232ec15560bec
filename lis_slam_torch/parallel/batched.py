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

`make_sharded_step` (the JAX mesh sharding of the lane axis) is not
ported: it needs several devices.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import SlamConfig
from ..pipeline import driver, odometry
from ..utils import device as devices


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


def replay_batched(sequences, cfg: SlamConfig,
                   device: torch.device | str = "cuda") -> np.ndarray:
    """sequences: B lists of scans (each an odometry.ScanInput on `device`,
    a SyntheticScan-like host object with ``.points`` and ``.valid``, or a
    raw (P, 4) numpy cloud); the shortest sets the length N. Returns
    the poses (B, N, 6) as numpy. Keyframe merges run on the host cadence
    cfg.runtime.batched_kf_every (1 = every scan, exactly the uniform step;
    scan 0 always merges so the map is seeded)."""
    device = devices.resolve(device)
    batch = len(sequences)
    n = min(len(s) for s in sequences)
    kf_every = max(1, cfg.runtime.batched_kf_every)
    states = batched_init_state(cfg, batch, device)
    poses = []
    for i in range(n):
        scans = stack_scans([_as_scan(seq[i], cfg, device)
                             for seq in sequences])
        states, outs = batched_odom_step(states, scans, cfg,
                                         allow_kf=(i % kf_every == 0))
        poses.append(outs.pose)
    if not poses:
        return np.zeros((batch, 0, 6), np.float32)
    return torch.stack(poses, dim=1).cpu().numpy()
