"""SO(3)/SE(3) utilities (port of lis_slam_tpu/utils/se3.py).

Poses are ``[roll, pitch, yaw, x, y, z]`` with the PCL convention
``R = Rz(yaw) @ Ry(pitch) @ Rx(roll)`` (pcl::getTransformation, reference
src/core/common.cpp:49-109). All functions are batched over leading dims
and keep their input's dtype (float32 geometry on the device, float64 for
the host IMU chain) and device.
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


def matmul_lanes(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b over leading (lane) dims as broadcast products summed in k
    order, so every entry rounds the same way whatever the number of
    lanes: a batched cuBLAS product picks its algorithm, and with it the
    rounding, by the batch count, and a lane's result would then depend on
    how many lanes run beside it."""
    out = a[..., :, :1] * b[..., :1, :]
    for k in range(1, a.shape[-1]):
        out = out + a[..., :, k:k + 1] * b[..., k:k + 1, :]
    return out


def transform_points_lanes(T: torch.Tensor, pts: torch.Tensor
                           ) -> torch.Tensor:
    """transform_points with the rotation applied by matmul_lanes."""
    return (matmul_lanes(pts, T[..., :3, :3].transpose(-1, -2))
            + T[..., None, :3, 3])


def transform_inverse_lanes(T: torch.Tensor) -> torch.Tensor:
    """transform_inverse with its product by matmul_lanes."""
    Rt = T[..., :3, :3].transpose(-1, -2)
    return make_transform(Rt, -matmul_lanes(Rt, T[..., :3, 3:4])[..., 0])


def apply_rotation(R: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Rotate (..., N, 3) points by (..., 3, 3)."""
    return torch.einsum("...ij,...nj->...ni", R, pts)


def hat(w: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) skew-symmetric matrix (Sophus::SO3::hat)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack([torch.stack([z, -wz, wy], dim=-1),
                        torch.stack([wz, z, -wx], dim=-1),
                        torch.stack([-wy, wx, z], dim=-1)], dim=-2)


def vee(W: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) skew -> (..., 3)."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues formula, (..., 3) axis-angle -> (..., 3, 3), with the
    Taylor series near theta=0. Both branches of torch.where are evaluated:
    theta is floored at 1e-12 so the far branch of a small angle stays
    finite instead of 0/0."""
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(torch.clamp(theta2, min=1e-24))
    small = theta2 < 1e-12
    t2 = torch.clamp(theta2, min=1e-24)
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / t2)
    W = hat(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(W.shape)
    return eye + a[..., None, None] * W + b[..., None, None] * (W @ W)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> (..., 3) axis-angle. Safe for theta in [0, pi)."""
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    theta = torch.acos(torch.clamp((tr - 1.0) / 2.0, -1.0, 1.0))
    small = theta < 1e-6
    scale = torch.where(small, 0.5 + theta * theta / 12.0,
                        theta / (2.0 * torch.clamp(torch.sin(theta),
                                                   min=1e-12)))
    return scale[..., None] * vee(R - R.transpose(-1, -2))


def _exp_coeffs(theta2: torch.Tensor):
    """sin(t)/t, (1-cos t)/t^2, (1 - sin(t)/t)/t^2 with series near t=0
    (theta^2 floored so the far branch of a small angle stays finite)."""
    theta = torch.sqrt(torch.clamp(theta2, min=1e-24))
    small = theta2 < 1e-12
    t2 = torch.clamp(theta2, min=1e-24)
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / t2)
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0, (1.0 - a) / t2)
    return a, b, c


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """(..., 6) twist [rho(3), w(3)] -> (..., 4, 4)."""
    rho, w = xi[..., :3], xi[..., 3:]
    a, b, c = _exp_coeffs(torch.sum(w * w, dim=-1))
    W = hat(w)
    W2 = W @ W
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device).expand(W.shape)
    R = eye + a[..., None, None] * W + b[..., None, None] * W2
    V = eye + b[..., None, None] * W + c[..., None, None] * W2
    return make_transform(R, torch.einsum("...ij,...j->...i", V, rho))


def se3_log(T: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) -> (..., 6) twist [rho, w]."""
    w = so3_log(T[..., :3, :3])
    theta2 = torch.sum(w * w, dim=-1)
    half = torch.sqrt(torch.clamp(theta2, min=1e-24)) / 2.0
    # V^-1 = I - W/2 + (1/theta^2)(1 - theta sin / (2(1-cos))) W^2
    cot = torch.where(
        theta2 < 1e-12, 1.0 / 12.0 + theta2 / 720.0,
        (1.0 - half * torch.cos(half) / torch.clamp(torch.sin(half),
                                                    min=1e-12))
        / torch.clamp(theta2, min=1e-24))
    W = hat(w)
    eye = torch.eye(3, dtype=T.dtype, device=T.device).expand(W.shape)
    Vinv = eye - 0.5 * W + cot[..., None, None] * (W @ W)
    rho = torch.einsum("...ij,...j->...i", Vinv, T[..., :3, 3])
    return torch.cat([rho, w], dim=-1)


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


def quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) [w,x,y,z] -> (..., 3, 3); a zero quaternion gives I."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    n = w * w + x * x + y * y + z * z
    s = torch.where(n > 0, 2.0 / torch.clamp(n, min=1e-24),
                    torch.zeros_like(n))
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    xx, xy, xz = s * x * x, s * x * y, s * x * z
    yy, yz, zz = s * y * y, s * y * z, s * z * z
    return torch.stack([
        torch.stack([1 - (yy + zz), xy - wz, xz + wy], dim=-1),
        torch.stack([xy + wz, 1 - (xx + zz), yz - wx], dim=-1),
        torch.stack([xz - wy, yz + wx, 1 - (xx + yy)], dim=-1),
    ], dim=-2)


def rot_to_quat(R: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> (..., 4) unit [w,x,y,z], branch-free Shepperd: the
    candidate of the largest pivot of four."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def root(v):
        return torch.sqrt(torch.clamp(1.0 + v, min=1e-12)) / 2.0

    a, b, c, d = (root(tr), root(m00 - m11 - m22), root(-m00 + m11 - m22),
                  root(-m00 - m11 + m22))
    cands = torch.stack([
        torch.stack([a, (m21 - m12) / (4 * a), (m02 - m20) / (4 * a),
                     (m10 - m01) / (4 * a)], dim=-1),
        torch.stack([(m21 - m12) / (4 * b), b, (m01 + m10) / (4 * b),
                     (m02 + m20) / (4 * b)], dim=-1),
        torch.stack([(m02 - m20) / (4 * c), (m01 + m10) / (4 * c), c,
                     (m12 + m21) / (4 * c)], dim=-1),
        torch.stack([(m10 - m01) / (4 * d), (m02 + m20) / (4 * d),
                     (m12 + m21) / (4 * d), d], dim=-1)], dim=-2)
    pivots = torch.stack([tr, m00 - m11 - m22, -m00 + m11 - m22,
                          -m00 - m11 + m22], dim=-1)
    idx = torch.argmax(pivots, dim=-1)
    q = torch.take_along_dim(cands, idx[..., None, None].expand(
        idx.shape + (1, 4)), dim=-2)[..., 0, :]
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


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
