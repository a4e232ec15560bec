"""Velocity-based motion compensation, the dataPretreat alternate front end
(port of lis_slam_tpu/ops/velocity_deskew.py; reference
src/core/distortionAdjust.cpp SyncData :4-178, AdjustCloud + UpdateMatrix
:412-480)."""

from __future__ import annotations

import torch

from ..utils import se3


def sync_to_time(stream_t: torch.Tensor, stream_v: torch.Tensor,
                 valid: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Linear interpolation of a (M, D) stream at time t (SyncData)."""
    tq = torch.where(valid, stream_t,
                     torch.full_like(stream_t, float("inf"))).contiguous()
    t = torch.as_tensor(t, dtype=tq.dtype, device=tq.device)
    n_valid = torch.sum(valid.to(torch.int32))
    hi = torch.searchsorted(tq, t.reshape(1), right=True)[0]
    hi = torch.minimum(torch.clamp(hi, min=1),
                       torch.clamp(n_valid - 1, min=1))
    lo = hi - 1
    t0, t1 = tq[lo], tq[hi]
    w = torch.clamp((t - t0) / torch.clamp(t1 - t0, min=1e-9), 0.0, 1.0)
    return stream_v[lo] + w * (stream_v[hi] - stream_v[lo])


def velocity_deskew(points: torch.Tensor, rel_time: torch.Tensor,
                    angular_rate: torch.Tensor, velocity: torch.Tensor,
                    valid: torch.Tensor) -> torch.Tensor:
    """Constant-velocity compensation to the scan-start frame
    (AdjustCloud/UpdateMatrix): p' = R(w t) p + v t, times relative to the
    scan start. A leading lane dim is allowed: (B, N, 3) points, (B, N)
    times and valid, (B, 3) rates."""
    R = se3.euler_to_rot(rel_time[..., None] * angular_rate[..., None, :])
    out = (torch.einsum("...nij,...nj->...ni", R, points)
           + rel_time[..., None] * velocity[..., None, :])
    return torch.where(valid[..., None], out, points)
