"""Laser pretreatment: ring id + relative-time synthesis, range gating
(port of lis_slam_tpu/ops/pretreatment.py; reference
src/core/laserPretreatment.cpp:4-160).

Inputs are padded buffers: `points` (P, 4) [x, y, z, intensity] with a
validity mask; invalid points keep mask=False throughout.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..config import SensorConfig


class PretreatedCloud(NamedTuple):
    """Pretreated scan: padded point buffer + per-point ring/time."""

    points: torch.Tensor  # (P, 4) x, y, z, intensity
    ring: torch.Tensor  # (P,) int32
    rel_time: torch.Tensor  # (P,) float32, seconds from scan start
    valid: torch.Tensor  # (P,) bool


def norm3(p: torch.Tensor) -> torch.Tensor:
    """Euclidean norm of the last axis of (..., 3), summed x, y, z in order
    (the order XLA's reduction uses, so integer quantizations of the range
    agree with the JAX package bit for bit)."""
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    return torch.sqrt(x * x + y * y + z * z)


def sum_sq3(diff: torch.Tensor) -> torch.Tensor:
    """sum(diff^2) over the last axis of size 3 as the JAX package's CPU
    program evaluates it: x^2, then two fused multiply-adds (emulated in
    float64: a float32 product is exact there, so only the sum rounds).
    A plain ((x^2 + y^2) + z^2) differs in the last bit for ~20% of
    points, which reorders near-ties."""
    d = diff.double()
    acc = (d[..., 0] * d[..., 0]).float()
    acc = (d[..., 1] * d[..., 1] + acc.double()).float()
    return (d[..., 2] * d[..., 2] + acc.double()).float()


def compute_ring(points: torch.Tensor, valid: torch.Tensor, n_scan: int):
    """Per-point ring id from the elevation angle, per-sensor formulas for
    16/32/64-beam Velodynes (laserPretreatment.cpp:33-60). Returns
    (ring int32, valid bool) — valid is ANDed with the ring-range checks."""
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    horiz = torch.sqrt(x * x + y * y)
    angle = torch.atan2(z, torch.clamp(horiz, min=1e-12)) * (180.0 / math.pi)
    if n_scan == 16:
        ring = torch.floor((angle + 15.0) / 2.0 + 0.5).to(torch.int32)
        ok = (ring >= 0) & (ring <= n_scan - 1)
    elif n_scan == 32:
        ring = torch.floor((angle + 92.0 / 3.0) * 3.0 / 4.0).to(torch.int32)
        ok = (ring >= 0) & (ring <= n_scan - 1)
    elif n_scan == 64:
        # HDL-64: upper block (angle >= -8.83 deg) at 1/3 deg spacing from
        # +2, lower block at 1/2 deg spacing; rows > 50 are outliers
        upper = torch.floor((2.0 - angle) * 3.0 + 0.5).to(torch.int32)
        lower = n_scan // 2 + torch.floor(
            (-8.83 - angle) * 2.0 + 0.5).to(torch.int32)
        ring = torch.where(angle >= -8.83, upper, lower)
        ok = (angle <= 2.0) & (angle >= -24.33) & (ring >= 0) & (ring <= 50)
    else:
        raise ValueError(f"unsupported N_SCAN={n_scan}")
    return torch.where(valid, ring, torch.full_like(ring, -1)), valid & ok


def compute_rel_time(points: torch.Tensor, valid: torch.Tensor,
                     scan_period: float) -> torch.Tensor:
    """Relative time in [0, scan_period] from the azimuth sweep fraction
    (startOri/endOri unwrap, laserPretreatment.cpp:17-20, 62-76), per scan
    of (..., P) points."""
    ori = -torch.atan2(points[..., 1], points[..., 0])
    n = ori.shape[-1]
    idx = torch.arange(n, device=ori.device)
    first = torch.argmin(torch.where(valid, idx, torch.full_like(idx, n + 1)),
                         dim=-1, keepdim=True)
    last = torch.argmax(torch.where(valid, idx, torch.full_like(idx, -1)),
                        dim=-1, keepdim=True)
    start_ori = torch.take_along_dim(ori, first, dim=-1)
    end_ori = torch.take_along_dim(ori, last, dim=-1) + 2.0 * math.pi
    span = end_ori - start_ori
    # reference clamps span into (pi, 3*pi)
    span = torch.where(span > 3.0 * math.pi, span - 2.0 * math.pi, span)
    span = torch.where(span < math.pi, span + 2.0 * math.pi, span)
    delta = torch.remainder(ori - start_ori, 2.0 * math.pi)
    rel = torch.clamp(delta / span, 0.0, 1.0)
    return torch.where(valid, rel * scan_period,
                       torch.zeros_like(rel)).to(torch.float32)


def pretreat(points: torch.Tensor, valid: torch.Tensor,
             cfg: SensorConfig) -> PretreatedCloud:
    """NaN/range gate + ring + relative time (LaserPretreatment::
    Pretreatment + removeClosedPointCloud, laserPretreatment.h:25-54).
    Scans may carry a leading lane dim: (B, P, 4) points, (B, P) valid."""
    finite = torch.all(torch.isfinite(points), dim=-1)
    rng = norm3(points[..., :3])
    in_range = ((rng >= cfg.lidar_min_range) & (rng <= cfg.lidar_max_range)
                & (rng > 1e-3))
    valid = valid & finite & in_range
    ring, valid = compute_ring(points, valid, cfg.n_scan)
    rel_time = compute_rel_time(points, valid, cfg.scan_period)
    pts = torch.where(valid[..., None], points, torch.zeros_like(points))
    return PretreatedCloud(points=pts, ring=ring, rel_time=rel_time,
                           valid=valid)
