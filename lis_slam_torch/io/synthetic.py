"""Synthetic HDL-64-style LiDAR world + sequence generator (host-side numpy).

Because this environment has no KITTI data (zero egress), correctness and
benchmark sequences are produced by raycasting a procedural urban world:
ground plane, axis-aligned building boxes, and cylindrical poles — enough
structure for LOAM edge/planar features, EPSC descriptors, and loop closure.

Each scan is emitted in the sensor frame in HDL-64 beam order (ring-major,
azimuth sweep), with optional motion distortion over the 0.1 s sweep and
per-point ground-truth semantic labels (learning-class ids matching
lis_slam_tpu.labels).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..labels import (
    LEARNING_CLASS_NAMES,
)

# learning-class ids used for ground truth
LBL_ROAD = LEARNING_CLASS_NAMES.index("road")
LBL_BUILDING = LEARNING_CLASS_NAMES.index("building")
LBL_POLE = LEARNING_CLASS_NAMES.index("pole")
LBL_CAR = LEARNING_CLASS_NAMES.index("car")
LBL_VEGETATION = LEARNING_CLASS_NAMES.index("vegetation")


@dataclass
class World:
    boxes: np.ndarray  # (B, 6) xmin,ymin,zmin,xmax,ymax,zmax
    box_labels: np.ndarray  # (B,) learning-class id
    poles: np.ndarray  # (Q, 4) cx, cy, radius, height
    ground_z: float = 0.0


def make_world(seed: int = 0, extent: float = 220.0, n_blocks: int = 9) -> World:
    """A grid of city blocks with buildings along the streets + poles."""
    rng = np.random.default_rng(seed)
    boxes = []
    labels = []
    # buildings arranged on a street grid so a loop trajectory stays in canyons
    block = extent / n_blocks
    for bx in range(n_blocks):
        for by in range(n_blocks):
            cx = -extent / 2 + (bx + 0.5) * block
            cy = -extent / 2 + (by + 0.5) * block
            # 1-3 buildings per block, leaving street margins
            for _ in range(rng.integers(1, 4)):
                w = rng.uniform(6, block * 0.55)
                d = rng.uniform(6, block * 0.55)
                h = rng.uniform(4, 18)
                ox = cx + rng.uniform(-block * 0.18, block * 0.18)
                oy = cy + rng.uniform(-block * 0.18, block * 0.18)
                boxes.append([ox - w / 2, oy - d / 2, 0.0, ox + w / 2, oy + d / 2, h])
                labels.append(LBL_BUILDING)
            # parked "car" boxes near street edges
            if rng.random() < 0.7:
                ox = cx + rng.choice([-1, 1]) * block * 0.42
                oy = cy + rng.uniform(-block * 0.3, block * 0.3)
                boxes.append([ox - 2.2, oy - 0.9, 0.0, ox + 2.2, oy + 0.9, 1.5])
                labels.append(LBL_CAR)
    # poles along streets
    poles = []
    for k in range(int(extent)):
        px = rng.uniform(-extent / 2, extent / 2)
        py = rng.uniform(-extent / 2, extent / 2)
        poles.append([px, py, rng.uniform(0.1, 0.25), rng.uniform(3, 8)])
    return World(
        boxes=np.asarray(boxes, dtype=np.float64),
        box_labels=np.asarray(labels, dtype=np.int32),
        poles=np.asarray(poles, dtype=np.float64),
    )


# HDL-64 elevation pattern consistent with the reference ring formula
# (laserPretreatment.cpp:49-56): upper 32 beams from +2deg at 1/3deg spacing,
# lower from -8.83deg at 1/2deg spacing. Rings 0..50 are valid.
def hdl64_elevations() -> np.ndarray:
    upper = 2.0 - np.arange(32) / 3.0  # rings 0..31
    lower = -8.83 - (np.arange(32) + 0.0) / 2.0  # rings 32..63
    return np.concatenate([upper, lower])


def raycast(
    world: World,
    origin: np.ndarray,  # (3,) or (N, 3) per-ray sensor origin in world
    directions: np.ndarray,  # (N, 3) unit rays in world frame
    max_range: float = 120.0,
):
    """Vectorized ray vs (ground plane | boxes | poles). Returns (t, label).

    Accepts per-ray origins so motion-distorted sweeps raycast from the
    TRUE firing-time position (a single shared origin would make the
    distorted scan geometrically inconsistent with the deskewed one)."""
    n = directions.shape[0]
    origin = np.broadcast_to(np.asarray(origin, float).reshape(-1, 3), (n, 3))
    t_best = np.full(n, np.inf)
    label = np.zeros(n, dtype=np.int32)

    # ground plane z = ground_z
    dz = directions[:, 2]
    with np.errstate(divide="ignore", invalid="ignore"):
        t_g = (world.ground_z - origin[:, 2]) / dz
    hit_g = (dz < -1e-6) & (t_g > 0.5) & (t_g < max_range)
    t_best = np.where(hit_g, t_g, t_best)
    label = np.where(hit_g, LBL_ROAD, label)

    # boxes: slab method, batched over boxes
    o = origin[None, :, :]  # (1,N,3)
    d = directions[None, :, :]  # (1,N,3)
    lo = world.boxes[:, None, 0:3]
    hi = world.boxes[:, None, 3:6]
    with np.errstate(divide="ignore", invalid="ignore"):
        inv = 1.0 / d
        t1 = (lo - o) * inv
        t2 = (hi - o) * inv
    tmin = np.minimum(t1, t2).max(axis=2)  # (B, N)
    tmax = np.maximum(t1, t2).min(axis=2)
    hit = (tmax >= tmin) & (tmax > 0) & (tmin > 0.5) & (tmin < max_range)
    t_box = np.where(hit, tmin, np.inf)
    bi = np.argmin(t_box, axis=0)  # (N,)
    t_bmin = t_box[bi, np.arange(n)]
    closer = t_bmin < t_best
    t_best = np.where(closer, t_bmin, t_best)
    label = np.where(closer, world.box_labels[bi], label)

    # poles: infinite cylinder intersection clipped by height
    if len(world.poles):
        cx = world.poles[:, None, 0]
        cy = world.poles[:, None, 1]
        r = world.poles[:, None, 2]
        h = world.poles[:, None, 3]
        ox, oy, oz = origin[:, 0], origin[:, 1], origin[:, 2]
        dx = directions[None, :, 0]
        dy = directions[None, :, 1]
        fx = ox[None, :] - cx
        fy = oy[None, :] - cy
        a = dx * dx + dy * dy
        b = 2 * (fx * dx + fy * dy)
        c = fx * fx + fy * fy - r * r
        disc = b * b - 4 * a * c
        with np.errstate(invalid="ignore", divide="ignore"):
            tq = (-b - np.sqrt(np.maximum(disc, 0.0))) / (2 * a)
        zhit = oz[None, :] + tq * directions[None, :, 2]
        hit = (disc > 0) & (tq > 0.5) & (tq < max_range) & (zhit > 0) & (zhit < h)
        t_p = np.where(hit, tq, np.inf)
        pi = np.argmin(t_p, axis=0)
        t_pmin = t_p[pi, np.arange(n)]
        closer = t_pmin < t_best
        t_best = np.where(closer, t_pmin, t_best)
        label = np.where(closer, LBL_POLE, label)

    return t_best, label


@dataclass
class SyntheticScan:
    points: np.ndarray  # (P, 4) xyzi in sensor frame (motion-distorted)
    labels: np.ndarray  # (P,) ground-truth learning-class id
    times: np.ndarray  # (P,) relative time within sweep
    valid: np.ndarray  # (P,) bool
    pose: np.ndarray  # (6,) ground-truth [roll,pitch,yaw,x,y,z] at scan start
    gyro: np.ndarray  # (M, 3) IMU gyro samples over the sweep (lidar frame)
    accel: np.ndarray  # (M, 3) IMU accel samples (lidar frame, incl. gravity)
    imu_time: np.ndarray  # (M,) relative seconds


def _pose_matrix(rpy_xyz: np.ndarray) -> np.ndarray:
    from scipy.spatial.transform import Rotation

    T = np.eye(4)
    T[:3, :3] = Rotation.from_euler("xyz", rpy_xyz[:3]).as_matrix()
    T[:3, 3] = rpy_xyz[3:]
    return T


def circular_trajectory(n_scans: int, radius: float = 60.0, speed: float = 8.0,
                        dt: float = 0.1, z: float = 1.8):
    """Closed-loop trajectory (returns (n,6) poses) driving a city circuit."""
    poses = []
    omega = speed / radius
    for i in range(n_scans):
        t = i * dt
        th = omega * t
        x = radius * np.sin(th)
        y = radius * (1 - np.cos(th))
        yaw = th
        poses.append([0.0, 0.0, yaw, x, y, z])
    return np.asarray(poses)


def render_scan(
    world: World,
    pose6: np.ndarray,
    next_pose6: np.ndarray | None = None,
    n_scan: int = 64,
    horizon: int = 1800,
    max_range: float = 120.0,
    noise: float = 0.01,
    seed: int = 0,
    n_imu: int = 24,
    sweep_time: float = 0.1,
) -> SyntheticScan:
    """Raycast one sweep. If next_pose6 is given, the sensor moves linearly
    through the sweep (motion distortion) and IMU gyro samples are emitted."""
    from scipy.spatial.transform import Rotation

    rng = np.random.default_rng(seed)
    elev = np.deg2rad(hdl64_elevations())
    az = np.linspace(0, 2 * np.pi, horizon, endpoint=False)
    # sweep starts at azimuth 0 (sensor +x) and goes clockwise (-yaw) like
    # a Velodyne; relative time = az fraction
    ring_idx = np.repeat(np.arange(n_scan), horizon)
    az_all = np.tile(az, n_scan)
    el_all = np.repeat(elev, horizon)
    rel_t = np.tile(az / (2 * np.pi) * sweep_time, n_scan)

    # direction in sensor frame at time of firing
    cos_e = np.cos(el_all)
    dirs_sensor = np.stack(
        [cos_e * np.cos(-az_all), cos_e * np.sin(-az_all), np.sin(el_all)], axis=1
    )

    T0 = _pose_matrix(pose6)
    if next_pose6 is not None:
        T1 = _pose_matrix(next_pose6)
        # interpolate pose over the sweep per point
        r0 = Rotation.from_euler("xyz", pose6[:3])
        r1 = Rotation.from_euler("xyz", next_pose6[:3])
        frac = rel_t / sweep_time
        slerped = Rotation.from_rotvec(
            (r1 * r0.inv()).as_rotvec()[None, :] * frac[:, None]
        ) * r0
        R_t = slerped.as_matrix()
        t_t = pose6[None, 3:] + frac[:, None] * (next_pose6[3:] - pose6[3:])[None, :]
    else:
        R_t = np.broadcast_to(T0[:3, :3], (len(dirs_sensor), 3, 3))
        t_t = np.broadcast_to(T0[:3, 3], (len(dirs_sensor), 3))

    dirs_world = np.einsum("nij,nj->ni", R_t, dirs_sensor)
    # raycast from the TRUE per-point (firing-time) origins
    t_hit, labels = raycast(world, t_t, dirs_world, max_range)
    hit = np.isfinite(t_hit)
    t_hit = np.where(hit, t_hit, 0.0)
    pts_world = t_t + dirs_world * t_hit[:, None]
    # express in the firing-time sensor frame (true distorted measurement)
    pts_sensor = np.einsum("nji,nj->ni", R_t, pts_world - t_t)
    pts_sensor += rng.normal(0, noise, pts_sensor.shape)
    intensity = np.where(labels == LBL_POLE, 0.8, 0.3) + rng.uniform(
        0, 0.2, len(labels)
    )
    points = np.concatenate([pts_sensor, intensity[:, None]], axis=1)
    points = np.where(hit[:, None], points, 0.0).astype(np.float32)

    # IMU: constant angular velocity + accel over the sweep
    imu_t = np.linspace(-0.005, sweep_time + 0.005, n_imu)
    g_w = np.array([0.0, 0.0, -9.80511])
    if next_pose6 is not None:
        rv = (r1 * r0.inv()).as_rotvec() / sweep_time
        # gyro in body frame: w_body = R0^T * w_world (constant twist approx)
        gyro = np.tile((r0.inv().as_matrix() @ rv)[None, :], (n_imu, 1))
        # specific force: under the constant-twist model the body turns with
        # w while translating with v, so the world-frame acceleration is the
        # centripetal term w x v; the accelerometer reads
        # f_body = R0^T (a_world - g_world). Omitting a_world made the IMU
        # physically inconsistent with the trajectory — a joint bias
        # estimator then correctly books w x v as an accel bias.
        v_w = (np.asarray(next_pose6[3:]) - np.asarray(pose6[3:])) / sweep_time
        a_w = np.cross(rv, v_w)
        f_body = r0.inv().as_matrix() @ (a_w - g_w)
        accel = np.tile(f_body[None, :], (n_imu, 1))
    else:
        gyro = np.zeros((n_imu, 3))
        accel = np.tile(-g_w[None, :], (n_imu, 1))

    # order points in beam-time order (azimuth-major within ring blocks,
    # matching KITTI bin layout: ring-major)
    return SyntheticScan(
        points=points,
        labels=labels.astype(np.int32) * hit,
        times=rel_t.astype(np.float32),
        valid=hit,
        pose=np.asarray(pose6, dtype=np.float64),
        gyro=gyro.astype(np.float32),
        accel=accel.astype(np.float32),
        imu_time=imu_t.astype(np.float32),
    )


def render_sequence(n_scans: int, seed: int = 0, **kw):
    """Generator of distorted scans along a circular loop trajectory."""
    world = make_world(seed)
    poses = circular_trajectory(n_scans + 1)
    for i in range(n_scans):
        yield render_scan(world, poses[i], poses[i + 1], seed=seed + i, **kw)
