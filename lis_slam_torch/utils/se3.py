"""SO(3)/SE(3) utilities (port of lis_slam_tpu/utils/se3.py).

Poses are ``[roll, pitch, yaw, x, y, z]`` with the PCL convention
``R = Rz(yaw) @ Ry(pitch) @ Rx(roll)`` (pcl::getTransformation, reference
src/core/common.cpp:49-109). All functions are batched over leading dims,
float32, and run on whatever device their input lies on.
"""

from __future__ import annotations

import torch


def euler_to_rot(rpy: torch.Tensor) -> torch.Tensor:
    """(..., 3) [roll, pitch, yaw] -> (..., 3, 3) rotation matrix."""
    roll, pitch, yaw = rpy[..., 0], rpy[..., 1], rpy[..., 2]
    cr, sr = torch.cos(roll), torch.sin(roll)
    cp, sp = torch.cos(pitch), torch.sin(pitch)
    cy, sy = torch.cos(yaw), torch.sin(yaw)
    rows = [
        [cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr],
        [sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr],
        [-sp, cp * sr, cp * cr],
    ]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def rot_to_euler(R: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> (..., 3) [roll, pitch, yaw], inverse of euler_to_rot."""
    pitch = torch.asin(torch.clamp(-R[..., 2, 0], -1.0, 1.0))
    roll = torch.atan2(R[..., 2, 1], R[..., 2, 2])
    yaw = torch.atan2(R[..., 1, 0], R[..., 0, 0])
    return torch.stack([roll, pitch, yaw], dim=-1)


def make_transform(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3), (..., 3) -> (..., 4, 4)."""
    top = torch.cat([R, t[..., :, None]], dim=-1)
    bottom = torch.zeros(top.shape[:-2] + (1, 4), dtype=top.dtype,
                         device=top.device)
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def pose_to_matrix(pose6: torch.Tensor) -> torch.Tensor:
    """(..., 6) [roll,pitch,yaw,x,y,z] -> (..., 4, 4) homogeneous transform."""
    return make_transform(euler_to_rot(pose6[..., :3]), pose6[..., 3:6])


def matrix_to_pose(T: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) -> (..., 6) [roll,pitch,yaw,x,y,z]."""
    return torch.cat([rot_to_euler(T[..., :3, :3]), T[..., :3, 3]], dim=-1)


def transform_inverse(T: torch.Tensor) -> torch.Tensor:
    """Closed-form SE(3) inverse of (..., 4, 4)."""
    Rt = T[..., :3, :3].transpose(-1, -2)
    ti = -torch.einsum("...ij,...j->...i", Rt, T[..., :3, 3])
    return make_transform(Rt, ti)


def transform_points(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply a (..., 4, 4) transform to (..., N, 3) points."""
    R = T[..., :3, :3]
    return torch.einsum("...ij,...nj->...ni", R, pts) + T[..., None, :3, 3]


def euler_to_quat(rpy: torch.Tensor) -> torch.Tensor:
    """(..., 3) [roll,pitch,yaw] -> (..., 4) [w,x,y,z] (tf setRPY)."""
    half = rpy * 0.5
    cr, sr = torch.cos(half[..., 0]), torch.sin(half[..., 0])
    cp, sp = torch.cos(half[..., 1]), torch.sin(half[..., 1])
    cy, sy = torch.cos(half[..., 2]), torch.sin(half[..., 2])
    return torch.stack([
        cr * cp * cy + sr * sp * sy,
        sr * cp * cy - cr * sp * sy,
        cr * sp * cy + sr * cp * sy,
        cr * cp * sy - sr * sp * cy,
    ], dim=-1)


def quat_to_euler(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) [w,x,y,z] -> (..., 3) [roll,pitch,yaw]."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    roll = torch.atan2(2 * (w * x + y * z), 1 - 2 * (x * x + y * y))
    pitch = torch.asin(torch.clamp(2 * (w * y - z * x), -1.0, 1.0))
    yaw = torch.atan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))
    return torch.stack([roll, pitch, yaw], dim=-1)


def quat_slerp(q0: torch.Tensor, q1: torch.Tensor, t: float) -> torch.Tensor:
    """Slerp between (..., 4) [w,x,y,z] quaternions (tf::Quaternion::slerp)."""
    dot = torch.sum(q0 * q1, dim=-1, keepdim=True)
    q1 = torch.where(dot < 0, -q1, q1)
    theta = torch.acos(torch.clamp(torch.abs(dot), -1.0, 1.0))
    sin_theta = torch.sin(theta)
    small = sin_theta < 1e-6
    denom = torch.clamp(sin_theta, min=1e-12)
    w0 = torch.where(small, 1.0 - t, torch.sin((1.0 - t) * theta) / denom)
    w1 = torch.where(small, t, torch.sin(t * theta) / denom)
    q = w0 * q0 + w1 * q1
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def constrain_angle(value: torch.Tensor, limit: float) -> torch.Tensor:
    """Clamp to [-limit, limit] (reference common.cpp:286-302
    constraintTransformation)."""
    return torch.clamp(value, -limit, limit)
