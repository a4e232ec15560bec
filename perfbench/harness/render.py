"""Frozen copy of the synthetic LiDAR renderers that make the traffic.

Copied, unchanged in what they compute, so that the benchmark's inputs do
not move when the program's own copies change, and rewritten to import
nothing of lis_slam_torch:

- `World`, `make_world`, `hdl64_elevations`, `circular_trajectory` and
  the label ids: lis_slam_torch/io/synthetic.py:25-79, 82-86, 181-193;
- `to_device_world`, `render_scan_device`, `imu_rows`, `plaza_world`:
  lis_slam_torch/io/synthetic_torch.py:19-200;
- the rotation helpers (`euler_to_rot`, `so3_exp`, `so3_log`, `hat`,
  `vee`, `pose_to_matrix`): lis_slam_torch/utils/se3.py:15-137 and
  utils/se3_np.py:15-27;
- `VLP16`: chip_smoke.py:240.

The plaza lap (chip_smoke.py `_render_plaza`, lines 1194-1230) and the
lio phase's distorted VLP-16 circuit (chip_smoke.py:1019-1031) are
assembled from these by harness/traffic.py.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

# learning-class ids (lis_slam_torch/labels.py LEARNING_CLASS_NAMES)
LBL_CAR = 1
LBL_ROAD = 9
LBL_BUILDING = 13
LBL_POLE = 18

VLP16 = np.linspace(15.0, -15.0, 16)


@dataclass
class World:
    boxes: np.ndarray  # (B, 6) xmin,ymin,zmin,xmax,ymax,zmax
    box_labels: np.ndarray  # (B,) learning-class id
    poles: np.ndarray  # (Q, 4) cx, cy, radius, height


def make_world(seed: int = 0, extent: float = 220.0,
               n_blocks: int = 9) -> World:
    """A grid of city blocks with buildings along the streets + poles."""
    rng = np.random.default_rng(seed)
    boxes, labels = [], []
    block = extent / n_blocks
    for bx in range(n_blocks):
        for by in range(n_blocks):
            cx = -extent / 2 + (bx + 0.5) * block
            cy = -extent / 2 + (by + 0.5) * block
            for _ in range(rng.integers(1, 4)):
                w = rng.uniform(6, block * 0.55)
                d = rng.uniform(6, block * 0.55)
                h = rng.uniform(4, 18)
                ox = cx + rng.uniform(-block * 0.18, block * 0.18)
                oy = cy + rng.uniform(-block * 0.18, block * 0.18)
                boxes.append([ox - w / 2, oy - d / 2, 0.0, ox + w / 2,
                              oy + d / 2, h])
                labels.append(LBL_BUILDING)
            if rng.random() < 0.7:
                ox = cx + rng.choice([-1, 1]) * block * 0.42
                oy = cy + rng.uniform(-block * 0.3, block * 0.3)
                boxes.append([ox - 2.2, oy - 0.9, 0.0, ox + 2.2, oy + 0.9,
                              1.5])
                labels.append(LBL_CAR)
    poles = []
    for _ in range(int(extent)):
        px = rng.uniform(-extent / 2, extent / 2)
        py = rng.uniform(-extent / 2, extent / 2)
        poles.append([px, py, rng.uniform(0.1, 0.25), rng.uniform(3, 8)])
    return World(boxes=np.asarray(boxes, dtype=np.float64),
                 box_labels=np.asarray(labels, dtype=np.int32),
                 poles=np.asarray(poles, dtype=np.float64))


def plaza_world() -> World:
    """The revisiting plaza of the JAX bench's full-SLAM section: 14
    buildings on a 30 m ring around (0, 10) and 24 poles at 17-22 m, from
    rng seed 9. The lap circular_trajectory(n + 1, radius=10, speed=2 pi 10
    / (n 0.1)) closes exactly after n scans."""
    rng = np.random.default_rng(9)
    boxes, poles = [], []
    for k in range(14):
        ang = 2 * np.pi * k / 14
        cx, cy = 30.0 * np.cos(ang), 10.0 + 30.0 * np.sin(ang)
        w, d, h = rng.uniform(6, 10), rng.uniform(6, 10), rng.uniform(5, 15)
        boxes.append([cx - w / 2, cy - d / 2, 0, cx + w / 2, cy + d / 2, h])
    for k in range(24):
        ang = 2 * np.pi * k / 24 + 0.1
        r = rng.uniform(17, 22)
        poles.append([r * np.cos(ang), 10.0 + r * np.sin(ang),
                      rng.uniform(0.1, 0.2), rng.uniform(3, 7)])
    return World(boxes=np.asarray(boxes),
                 box_labels=np.full(14, LBL_BUILDING, np.int32),
                 poles=np.asarray(poles))


def hdl64_elevations() -> np.ndarray:
    upper = 2.0 - np.arange(32) / 3.0
    lower = -8.83 - (np.arange(32) + 0.0) / 2.0
    return np.concatenate([upper, lower])


ELEVATIONS = {"hdl64": hdl64_elevations, "vlp16": lambda: VLP16}


def circular_trajectory(n_scans: int, radius: float = 60.0,
                        speed: float = 8.0, dt: float = 0.1,
                        z: float = 1.8) -> np.ndarray:
    """Closed-loop trajectory, (n, 6) poses [roll, pitch, yaw, x, y, z]."""
    poses = []
    omega = speed / radius
    for i in range(n_scans):
        th = omega * i * dt
        poses.append([0.0, 0.0, th, radius * np.sin(th),
                      radius * (1 - np.cos(th)), z])
    return np.asarray(poses)


# ---- rotation helpers (R = Rz(yaw) Ry(pitch) Rx(roll)) ----

def euler_to_rot(rpy: torch.Tensor) -> torch.Tensor:
    roll, pitch, yaw = rpy[..., 0], rpy[..., 1], rpy[..., 2]
    cr, sr = torch.cos(roll), torch.sin(roll)
    cp, sp = torch.cos(pitch), torch.sin(pitch)
    cy, sy = torch.cos(yaw), torch.sin(yaw)
    rows = [[cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr],
            [sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr],
            [-sp, cp * sr, cp * cr]]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def hat(w: torch.Tensor) -> torch.Tensor:
    z = torch.zeros_like(w[..., 0])
    return torch.stack([torch.stack([z, -w[..., 2], w[..., 1]], -1),
                        torch.stack([w[..., 2], z, -w[..., 0]], -1),
                        torch.stack([-w[..., 1], w[..., 0], z], -1)], -2)


def vee(W: torch.Tensor) -> torch.Tensor:
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], -1)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
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
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    theta = torch.acos(torch.clamp((tr - 1.0) / 2.0, -1.0, 1.0))
    small = theta < 1e-6
    scale = torch.where(small, 0.5 + theta * theta / 12.0,
                        theta / (2.0 * torch.clamp(torch.sin(theta),
                                                   min=1e-12)))
    return scale[..., None] * vee(R - R.transpose(-1, -2))


def pose_to_matrix_np(pose6: np.ndarray) -> np.ndarray:
    r, p, y = pose6[0], pose6[1], pose6[2]
    cr, sr = np.cos(r), np.sin(r)
    cp, sp = np.cos(p), np.sin(p)
    cy, sy = np.cos(y), np.sin(y)
    Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    T = np.eye(4)
    T[:3, :3] = Rz @ Ry @ Rx
    T[:3, 3] = pose6[3:]
    return T


# ---- the on-device raycast ----

@dataclass
class TorchWorld:
    boxes: torch.Tensor
    box_labels: torch.Tensor
    poles: torch.Tensor


def to_device_world(world: World, device) -> TorchWorld:
    return TorchWorld(
        boxes=torch.as_tensor(world.boxes, dtype=torch.float32, device=device),
        box_labels=torch.as_tensor(world.box_labels, device=device),
        poles=torch.as_tensor(world.poles, dtype=torch.float32, device=device))


def render_scan_device(world: TorchWorld, pose6: torch.Tensor,
                       generator: torch.Generator | None, n_scan: int = 64,
                       horizon: int = 1800, max_range: float = 120.0,
                       noise: float = 0.01,
                       next_pose6: torch.Tensor | None = None,
                       elevations=None):
    """Raycast one sweep from pose6. Returns (points (P,4), labels (P,),
    valid (P,)) in the sensor frame, beam order ring-major. With
    `next_pose6` the sweep is motion-distorted: each point's pose is
    slerped from pose6 to next_pose6 by its azimuth's fraction of the
    sweep, and the point is expressed in the firing-time sensor frame."""
    dev = world.boxes.device
    f32 = dict(dtype=torch.float32, device=dev)
    if elevations is None:
        elevations = hdl64_elevations()
    elev = torch.deg2rad(torch.as_tensor(np.asarray(elevations), **f32))
    az = torch.arange(horizon, **f32) * (2 * np.pi / horizon)
    el_all = torch.repeat_interleave(elev[:n_scan], horizon)
    az_all = az.repeat(n_scan)
    cos_e = torch.cos(el_all)
    dirs_sensor = torch.stack([cos_e * torch.cos(-az_all),
                               cos_e * torch.sin(-az_all),
                               torch.sin(el_all)], dim=1)
    pose6 = pose6.to(**f32)
    R = euler_to_rot(pose6[:3])
    if next_pose6 is None:
        origin = pose6[3:].expand(dirs_sensor.shape[0], 3)
        d = dirs_sensor @ R.T
    else:
        next_pose6 = next_pose6.to(**f32)
        R1 = euler_to_rot(next_pose6[:3])
        rv = so3_log((R1 @ R.T).double()).float()
        frac = (az / (2 * np.pi)).repeat(n_scan)
        R = so3_exp(frac[:, None] * rv) @ R
        origin = pose6[3:] + frac[:, None] * (next_pose6[3:] - pose6[3:])
        d = torch.einsum("nij,nj->ni", R, dirs_sensor)
    inf = torch.full((d.shape[0],), float("inf"), **f32)

    dz = d[:, 2]
    t_g = -origin[:, 2] / torch.where(torch.abs(dz) > 1e-6, dz,
                                      torch.full_like(dz, -1e-6))
    hit_g = (dz < -1e-6) & (t_g > 0.5) & (t_g < max_range)
    t_best = torch.where(hit_g, t_g, inf)
    label = torch.where(hit_g, LBL_ROAD, 0).to(torch.int32)

    inv = 1.0 / torch.where(torch.abs(d) > 1e-9, d, torch.full_like(d, 1e-9))
    lo = world.boxes[:, None, 0:3]
    hi = world.boxes[:, None, 3:6]
    t1 = (lo - origin) * inv[None]
    t2 = (hi - origin) * inv[None]
    tmin = torch.amax(torch.minimum(t1, t2), dim=2)
    tmax = torch.amin(torch.maximum(t1, t2), dim=2)
    del t1, t2
    hit = (tmax >= tmin) & (tmax > 0) & (tmin > 0.5) & (tmin < max_range)
    t_bmin, bi = torch.min(torch.where(hit, tmin, inf[None]), dim=0)
    closer = t_bmin < t_best
    t_best = torch.where(closer, t_bmin, t_best)
    label = torch.where(closer, world.box_labels[bi].to(torch.int32), label)

    cx, cy = world.poles[:, 0:1], world.poles[:, 1:2]
    r, h = world.poles[:, 2:3], world.poles[:, 3:4]
    fx, fy = origin[None, :, 0] - cx, origin[None, :, 1] - cy
    dx, dy = d[None, :, 0], d[None, :, 1]
    a = dx * dx + dy * dy
    b = 2 * (fx * dx + fy * dy)
    c = fx * fx + fy * fy - r * r
    disc = b * b - 4 * a * c
    tq = (-b - torch.sqrt(torch.clamp(disc, min=0.0))) / (
        2 * torch.clamp(a, min=1e-12))
    zhit = origin[None, :, 2] + tq * d[None, :, 2]
    hitp = ((disc > 0) & (tq > 0.5) & (tq < max_range) & (zhit > 0)
            & (zhit < h))
    t_pmin = torch.amin(torch.where(hitp, tq, inf[None]), dim=0)
    closer = t_pmin < t_best
    t_best = torch.where(closer, t_pmin, t_best)
    label = torch.where(closer, LBL_POLE, label).to(torch.int32)

    valid = torch.isfinite(t_best)
    t_hit = torch.where(valid, t_best, torch.zeros_like(t_best))
    if next_pose6 is None:
        pts_sensor = (d * t_hit[:, None]) @ R
    else:
        pts_sensor = torch.einsum("nji,nj->ni", R, d * t_hit[:, None])
    pts_sensor = pts_sensor + noise * torch.randn(
        pts_sensor.shape, generator=generator, **f32)
    intensity = torch.where(label == LBL_POLE, 0.8, 0.3) + 0.2 * torch.rand(
        pts_sensor.shape[0], generator=generator, **f32)
    points = torch.cat([pts_sensor, intensity[:, None]], dim=1)
    points = torch.where(valid[:, None], points, torch.zeros_like(points))
    return points, torch.where(valid, label, torch.zeros_like(label)), valid


def imu_rows(pose6: np.ndarray, next_pose6: np.ndarray | None,
             n_imu: int = 24, sweep_time: float = 0.1):
    """The IMU samples of a sweep, on the host in float64: n_imu times over
    [-0.005, sweep + 0.005] s, the body-frame gyro of the constant twist
    from pose6 to next_pose6, and the specific force R0^T (w x v - g).
    Returns (gyro (n,3), accel (n,3), imu_time (n,)) float32, lidar
    frame."""
    imu_t = np.linspace(-0.005, sweep_time + 0.005, n_imu)
    g_w = np.array([0.0, 0.0, -9.80511])
    if next_pose6 is None:
        gyro = np.zeros((n_imu, 3))
        accel = np.tile(-g_w[None, :], (n_imu, 1))
    else:
        R0 = pose_to_matrix_np(np.asarray(pose6, np.float64))[:3, :3]
        R1 = pose_to_matrix_np(np.asarray(next_pose6, np.float64))[:3, :3]
        rv = so3_log(torch.from_numpy(R1 @ R0.T)).numpy() / sweep_time
        v_w = (np.asarray(next_pose6[3:]) - np.asarray(pose6[3:])) / sweep_time
        gyro = np.tile((R0.T @ rv)[None, :], (n_imu, 1))
        accel = np.tile((R0.T @ (np.cross(rv, v_w) - g_w))[None, :],
                        (n_imu, 1))
    return (gyro.astype(np.float32), accel.astype(np.float32),
            imu_t.astype(np.float32))


def lap_speed(radius: float, lap_scans: int, dt: float = 0.1) -> float:
    """The speed at which circular_trajectory closes after lap_scans."""
    return 2.0 * math.pi * radius / (lap_scans * dt)
