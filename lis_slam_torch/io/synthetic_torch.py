"""On-device synthetic scan renderer (port of
lis_slam_tpu/io/synthetic_jax.py): the same world model and raycast as the
numpy renderer in io/synthetic.py, as tensor ops, so a benchmark sequence
renders on the card in milliseconds instead of seconds per scan on a
host CPU. Noise comes from a `torch.Generator` on the world's device, so
the bits differ from the JAX renderer's; the geometry does not."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..utils import se3, se3_np
from . import synthetic


class TorchWorld(NamedTuple):
    boxes: torch.Tensor  # (B, 6) xmin,ymin,zmin,xmax,ymax,zmax
    box_labels: torch.Tensor  # (B,)
    poles: torch.Tensor  # (Q, 4) cx, cy, radius, height


def to_device_world(world: synthetic.World,
                    device: torch.device | str) -> TorchWorld:
    return TorchWorld(
        boxes=torch.as_tensor(world.boxes, dtype=torch.float32, device=device),
        box_labels=torch.as_tensor(world.box_labels, device=device),
        poles=torch.as_tensor(world.poles, dtype=torch.float32, device=device),
    )


def render_scan_device(world: TorchWorld, pose6: torch.Tensor,
                       generator: torch.Generator | None, n_scan: int = 64,
                       horizon: int = 1800, max_range: float = 120.0,
                       noise: float = 0.01,
                       next_pose6: torch.Tensor | None = None,
                       elevations=None):
    """Raycast one sweep from pose6. Returns (points (P,4), labels (P,),
    valid (P,)) in the sensor frame, beam order ring-major.

    With `next_pose6` the sweep is motion-distorted as in the numpy
    render_scan: each point's pose is slerped from pose6 to next_pose6 by
    its firing time (its azimuth's fraction of the sweep), the ray leaves
    from that pose, and the point is expressed in the firing-time sensor
    frame.
    `elevations` are the beam angles in degrees (default the HDL-64 fan;
    np.linspace(15, -15, 16) for a VLP-16)."""
    dev = world.boxes.device
    f32 = dict(dtype=torch.float32, device=dev)
    if elevations is None:
        elevations = synthetic.hdl64_elevations()
    elev = torch.deg2rad(torch.as_tensor(np.asarray(elevations), **f32))
    az = torch.arange(horizon, **f32) * (2 * np.pi / horizon)
    el_all = torch.repeat_interleave(elev[:n_scan], horizon)
    az_all = az.repeat(n_scan)
    cos_e = torch.cos(el_all)
    dirs_sensor = torch.stack([cos_e * torch.cos(-az_all),
                               cos_e * torch.sin(-az_all),
                               torch.sin(el_all)], dim=1)
    pose6 = pose6.to(**f32)
    R = se3.euler_to_rot(pose6[:3])
    if next_pose6 is None:
        origin = pose6[3:].expand(dirs_sensor.shape[0], 3)
        d = dirs_sensor @ R.T  # (P, 3) world-frame directions
    else:
        # per-point pose at its firing time (fraction of the sweep = the
        # azimuth fraction): slerp of the rotation, lerp of the position
        next_pose6 = next_pose6.to(**f32)
        R1 = se3.euler_to_rot(next_pose6[:3])
        rv = se3.so3_log((R1 @ R.T).double()).float()
        frac = (az / (2 * np.pi)).repeat(n_scan)
        R = se3.so3_exp(frac[:, None] * rv) @ R  # (P, 3, 3)
        origin = pose6[3:] + frac[:, None] * (next_pose6[3:] - pose6[3:])
        d = torch.einsum("nij,nj->ni", R, dirs_sensor)
    inf = torch.full((d.shape[0],), float("inf"), **f32)

    # ground plane z=0
    dz = d[:, 2]
    t_g = -origin[:, 2] / torch.where(torch.abs(dz) > 1e-6, dz,
                                   torch.full_like(dz, -1e-6))
    hit_g = (dz < -1e-6) & (t_g > 0.5) & (t_g < max_range)
    t_best = torch.where(hit_g, t_g, inf)
    label = torch.where(hit_g, synthetic.LBL_ROAD, 0).to(torch.int32)

    # boxes (slab method)
    inv = 1.0 / torch.where(torch.abs(d) > 1e-9, d, torch.full_like(d, 1e-9))
    lo = world.boxes[:, None, 0:3]
    hi = world.boxes[:, None, 3:6]
    t1 = (lo - origin) * inv[None]
    t2 = (hi - origin) * inv[None]
    tmin = torch.amax(torch.minimum(t1, t2), dim=2)  # (B, P)
    tmax = torch.amin(torch.maximum(t1, t2), dim=2)
    del t1, t2
    hit = (tmax >= tmin) & (tmax > 0) & (tmin > 0.5) & (tmin < max_range)
    t_bmin, bi = torch.min(torch.where(hit, tmin, inf[None]), dim=0)
    closer = t_bmin < t_best
    t_best = torch.where(closer, t_bmin, t_best)
    label = torch.where(closer, world.box_labels[bi].to(torch.int32), label)

    # poles (cylinders)
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
    label = torch.where(closer, synthetic.LBL_POLE, label).to(torch.int32)

    valid = torch.isfinite(t_best)
    t_hit = torch.where(valid, t_best, torch.zeros_like(t_best))
    if next_pose6 is None:
        pts_sensor = (d * t_hit[:, None]) @ R  # R^T applied from the right
    else:
        pts_sensor = torch.einsum("nji,nj->ni", R, d * t_hit[:, None])
    pts_sensor = pts_sensor + noise * torch.randn(
        pts_sensor.shape, generator=generator, **f32)
    intensity = torch.where(label == synthetic.LBL_POLE, 0.8, 0.3) + 0.2 * \
        torch.rand(pts_sensor.shape[0], generator=generator, **f32)
    points = torch.cat([pts_sensor, intensity[:, None]], dim=1)
    points = torch.where(valid[:, None], points, torch.zeros_like(points))
    return points, torch.where(valid, label, torch.zeros_like(label)), valid


def imu_rows(pose6: np.ndarray, next_pose6: np.ndarray | None,
             n_imu: int = 24, sweep_time: float = 0.1):
    """The IMU samples of the numpy render_scan (io/synthetic.py:259-278),
    on the host in float64: n_imu times over [-0.005, sweep + 0.005] s, the
    body-frame gyro of the constant twist from pose6 to next_pose6, and the
    specific force R0^T (w x v - g). Returns (gyro (n,3), accel (n,3),
    imu_time (n,)) float32, lidar frame."""
    imu_t = np.linspace(-0.005, sweep_time + 0.005, n_imu)
    g_w = np.array([0.0, 0.0, -9.80511])
    if next_pose6 is None:
        gyro = np.zeros((n_imu, 3))
        accel = np.tile(-g_w[None, :], (n_imu, 1))
    else:
        R0 = se3_np.pose_to_matrix(np.asarray(pose6, np.float64))[:3, :3]
        R1 = se3_np.pose_to_matrix(np.asarray(next_pose6, np.float64))[:3, :3]
        rv = se3.so3_log(torch.from_numpy(R1 @ R0.T)).numpy() / sweep_time
        v_w = (np.asarray(next_pose6[3:]) - np.asarray(pose6[3:])) / sweep_time
        gyro = np.tile((R0.T @ rv)[None, :], (n_imu, 1))
        accel = np.tile((R0.T @ (np.cross(rv, v_w) - g_w))[None, :],
                        (n_imu, 1))
    return (gyro.astype(np.float32), accel.astype(np.float32),
            imu_t.astype(np.float32))


def render_sequence_device(n_scans: int, seed: int = 5, radius: float = 60.0,
                           speed: float = 8.0,
                           device: torch.device | str = "cpu",
                           distorted: bool = False, **kw):
    """Render a bench sequence on `device`: the world of `make_world(seed)`
    along `circular_trajectory(n_scans + 1, radius, speed)`; with
    `distorted`, each sweep moves from gt[i] to gt[i + 1]. Returns (list of
    (points, labels, valid), gt poses (n+1, 6) numpy)."""
    world = to_device_world(synthetic.make_world(seed), device)
    gt = synthetic.circular_trajectory(n_scans + 1, radius=radius,
                                       speed=speed)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    scans = [render_scan_device(
        world, torch.as_tensor(gt[i]), gen,
        next_pose6=torch.as_tensor(gt[i + 1]) if distorted else None, **kw)
        for i in range(n_scans)]
    return scans, gt
