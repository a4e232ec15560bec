"""A check for the harness's own tests (test_bench_checks.py), in the
form of perfbench/checks/<check>.py: the program's pose-to-matrix
(`utils/se3.pose_to_matrix`) on the sampled scans against a float64
restatement of the same formula. `pose_matrix_gap`: the widest entry of
the difference between a matrix the program formed and the reference's,
over every single-pose call of the sampled scans of the judged session.
The control is the reference in bfloat16."""

from __future__ import annotations

import math

import torch

NUMBERS = ("pose_matrix_gap",)
CAPTURES = (("lis_slam_torch.utils.se3", "pose_to_matrix"),)


def keep(scan_index, sample, args, kwargs, result):
    pose = args[0] if args else kwargs["pose6"]
    if scan_index not in sample or pose.dim() != 1:
        return None
    return (pose.detach().to("cpu", torch.float64),
            result.detach().to("cpu", torch.float64))


def matrix(pose: torch.Tensor, dtype) -> torch.Tensor:
    """[roll, pitch, yaw, x, y, z] -> 4x4, R = Rz Ry Rx, in `dtype`."""
    r, p, y = pose[:3].to(dtype)
    cr, sr, cp, sp = torch.cos(r), torch.sin(r), torch.cos(p), torch.sin(p)
    cy, sy = torch.cos(y), torch.sin(y)
    one, zero = torch.ones((), dtype=dtype), torch.zeros((), dtype=dtype)
    Rx = torch.stack([one, zero, zero, zero, cr, -sr, zero, sr, cr])
    Ry = torch.stack([cp, zero, sp, zero, one, zero, -sp, zero, cp])
    Rz = torch.stack([cy, -sy, zero, sy, cy, zero, zero, zero, one])
    T = torch.eye(4, dtype=dtype)
    T[:3, :3] = Rz.view(3, 3) @ Ry.view(3, 3) @ Rx.view(3, 3)
    T[:3, 3] = pose[3:].to(dtype)
    return T


def _gap(captured, answer) -> float:
    if not captured:
        return math.inf
    return max(float((answer(pose, got) - matrix(pose, torch.float64))
                     .abs().max()) for pose, got in captured)


def readings(captured, cfg, traffic, device) -> dict:
    return {"pose_matrix_gap": _gap(captured, lambda _pose, got: got)}


def control(captured, cfg, traffic, device) -> dict:
    return {"pose_matrix_gap": _gap(
        captured,
        lambda pose, _got: matrix(pose, torch.bfloat16).to(torch.float64))}
