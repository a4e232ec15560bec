"""IMU-rotation motion deskew (port of lis_slam_tpu/ops/deskew.py;
reference src/core/laserProcessing.cpp imuDeskewInfo :211-266,
findRotation :368-400, deskewPoint :427-462).

The gyro window is a padded (M,) buffer with a validity mask. The angles
integrate per axis (not on SO(3)), as the reference does. Runs on the
device of the points, over every raw point of the scan.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils import se3


class DeskewInfo(NamedTuple):
    """Per-scan rotation curves integrated from gyro (padded to M samples)."""

    times: torch.Tensor  # (M,) seconds from scan start, +inf in padding
    rot_xyz: torch.Tensor  # (M, 3) integrated angles at each sample
    count: torch.Tensor  # () int32, number of valid samples
    available: torch.Tensor  # () bool — imuAvailable flag


def integrate_gyro(imu_time: torch.Tensor, imu_gyro: torch.Tensor,
                   imu_valid: torch.Tensor, scan_start: torch.Tensor
                   ) -> DeskewInfo:
    """Cumulative per-axis angle integration (imuDeskewInfo). The first
    valid sample anchors angle 0; padding slots add nothing, so the curve
    saturates at its last valid value."""
    m = imu_time.shape[0]
    t_rel = imu_time - scan_start
    prev_t = torch.cat([t_rel[:1], t_rel[:-1]])
    dt = torch.where(imu_valid, t_rel - prev_t, torch.zeros_like(t_rel))
    # first True (0 if none), as jnp.argmax over a bool mask
    first = torch.argmax(imu_valid.to(torch.int32))
    dt = torch.where(torch.arange(m, device=dt.device) == first,
                     torch.zeros_like(dt), dt)
    incr = torch.where(imu_valid[:, None], imu_gyro * dt[:, None],
                       torch.zeros_like(imu_gyro))
    count = torch.sum(imu_valid.to(torch.int32))
    # padding times at +inf so searchsorted never lands there
    t_query = torch.where(imu_valid, t_rel, torch.full_like(t_rel,
                                                            float("inf")))
    return DeskewInfo(times=t_query.to(torch.float32).contiguous(),
                      rot_xyz=torch.cumsum(incr, dim=0).to(torch.float32),
                      count=count, available=count >= 2)


def rotation_at(info: DeskewInfo, t: torch.Tensor) -> torch.Tensor:
    """(N,) point times -> (N, 3) interpolated angles (findRotation),
    saturating at the window's ends."""
    hi = torch.searchsorted(info.times, t.contiguous(), right=True)
    last = torch.clamp(info.count - 1, min=0)
    # jnp.clip(hi, 1, last): with fewer than 2 samples hi = 0 and lo = -1,
    # which wraps to the last slot in both frameworks
    hi = torch.minimum(torch.clamp(hi, min=1), last)
    lo = hi - 1
    t_lo, t_hi = info.times[lo], info.times[hi]
    w = torch.clamp((t - t_lo) / torch.clamp(t_hi - t_lo, min=1e-9), 0.0, 1.0)
    r_lo = info.rot_xyz[lo]
    return r_lo + w[:, None] * (info.rot_xyz[hi] - r_lo)


def deskew_points(points: torch.Tensor, t: torch.Tensor, info: DeskewInfo,
                  valid: torch.Tensor,
                  vel_body: torch.Tensor | None = None) -> torch.Tensor:
    """Rotate points into the frame at the earliest valid point time t0
    (deskewPoint): p' = R(t0)^T R(t) p, plus vel_body * (t - t0) when a
    scan-start body velocity is given (the findPosition term the reference
    zeroes). Points pass through unchanged when the window is not
    `available` or the point is invalid."""
    rpy = rotation_at(info, t)
    t0 = torch.min(torch.where(valid, t, torch.full_like(t, float("inf"))))
    rpy0 = rotation_at(info, t0[None])[0]
    R = se3.euler_to_rot(rpy)
    R0 = se3.euler_to_rot(rpy0)
    Rbt = torch.einsum("ji,njk->nik", R0, R)
    out = torch.einsum("nij,nj->ni", Rbt, points)
    if vel_body is not None:
        out = out + vel_body[None, :] * (t - t0)[:, None]
    use = valid & info.available
    return torch.where(use[:, None], out, points)
