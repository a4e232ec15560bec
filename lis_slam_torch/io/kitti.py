"""KITTI odometry dataset IO: velodyne .bin scans, calib, poses, OXTS IMU.

Replaces the reference's rosbag ingestion path (`rosbag play` +
laserPretreatmentNode): KITTI bins are read straight into the padded scan
buffers the pipeline consumes. Also provides the ground-truth pose reader
for ATE evaluation and an OXTS parser for the IMU-aided configs.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np


def read_velodyne_bin(path: str) -> np.ndarray:
    """(P, 4) float32 x, y, z, reflectance."""
    data = np.fromfile(path, dtype=np.float32)
    return data.reshape(-1, 4)


def read_poses(path: str) -> np.ndarray:
    """KITTI ground-truth poses file -> (N, 4, 4) (cam0 frame)."""
    rows = np.loadtxt(path).reshape(-1, 3, 4)
    out = np.tile(np.eye(4), (len(rows), 1, 1))
    out[:, :3, :] = rows
    return out


def read_calib(path: str) -> dict:
    """calib.txt -> dict of (3,4) matrices; 'Tr' maps velodyne -> cam0."""
    out = {}
    with open(path) as f:
        for line in f:
            if ":" not in line:
                continue
            k, v = line.split(":", 1)
            vals = np.fromstring(v, sep=" ")
            if vals.size == 12:
                out[k.strip()] = vals.reshape(3, 4)
    return out


def poses_to_velodyne_frame(poses_cam: np.ndarray, Tr: np.ndarray) -> np.ndarray:
    """Ground-truth cam0 poses -> velodyne-frame trajectory:
    T_velo_i = Tr^-1 @ T_cam_i @ Tr."""
    T = np.eye(4)
    T[:3, :] = Tr
    Ti = np.linalg.inv(T)
    return np.einsum("ij,njk,kl->nil", Ti, poses_cam, T)


@dataclass
class KittiSequence:
    """Lazy reader over a KITTI odometry sequence directory layout:
    <root>/sequences/<seq>/velodyne/*.bin (+ calib.txt, times.txt) and
    <root>/poses/<seq>.txt for ground truth."""

    root: str
    sequence: str

    def __post_init__(self):
        self.seq_dir = os.path.join(self.root, "sequences", self.sequence)
        self.velo_dir = os.path.join(self.seq_dir, "velodyne")
        if not os.path.isdir(self.velo_dir):
            raise FileNotFoundError(
                f"KITTI sequence not found: {self.velo_dir} "
                f"(expected <root>/sequences/<seq>/velodyne/*.bin)"
            )
        self.files = sorted(
            f for f in os.listdir(self.velo_dir) if f.endswith(".bin")
        )
        if not self.files:
            raise FileNotFoundError(f"no .bin scans in {self.velo_dir}")
        times_path = os.path.join(self.seq_dir, "times.txt")
        self.times = (
            np.loadtxt(times_path) if os.path.exists(times_path) else
            np.arange(len(self.files)) * 0.1
        )
        calib_path = os.path.join(self.seq_dir, "calib.txt")
        self.calib = read_calib(calib_path) if os.path.exists(calib_path) else {}

    def __len__(self):
        return len(self.files)

    def scan(self, i: int) -> np.ndarray:
        return read_velodyne_bin(os.path.join(self.velo_dir, self.files[i]))

    def ground_truth(self) -> np.ndarray | None:
        p = os.path.join(self.root, "poses", f"{self.sequence}.txt")
        if not os.path.exists(p):
            return None
        poses = read_poses(p)
        if "Tr" in self.calib:
            poses = poses_to_velodyne_frame(poses, self.calib["Tr"])
        return poses

    def __iter__(self):
        for i in range(len(self)):
            yield self.scan(i)


# ---------------------------------------------------------------------------
# OXTS (KITTI raw) IMU parsing for the LIO configs
# ---------------------------------------------------------------------------

_OXTS_FIELDS = 30  # lat lon alt roll pitch yaw ... wx wy wz ax ay az ...


def read_oxts_file(path: str) -> np.ndarray:
    return np.loadtxt(path).reshape(-1)


def oxts_to_imu(oxts_row: np.ndarray):
    """Extract (gyro xyz rad/s, accel xyz m/s^2, rpy) from an OXTS record."""
    rpy = oxts_row[3:6]
    accel = oxts_row[11:14]
    gyro = oxts_row[17:20]
    return gyro, accel, rpy


# ---------------------------------------------------------------------------
# Point-cloud export (savePCD equivalent)
# ---------------------------------------------------------------------------


def write_pcd(path: str, points: np.ndarray, labels: np.ndarray | None = None):
    """ASCII PCD writer (reference saves trajectory/cloudGlobal PCDs,
    subMapOptmizationNode.cpp:3490-3516)."""
    n = len(points)
    fields = "x y z" + (" label" if labels is not None else "")
    sizes = "4 4 4" + (" 4" if labels is not None else "")
    types = "F F F" + (" U" if labels is not None else "")
    counts = "1 1 1" + (" 1" if labels is not None else "")
    with open(path, "w") as f:
        f.write(
            "# .PCD v0.7 - Point Cloud Data file format\n"
            f"VERSION 0.7\nFIELDS {fields}\nSIZE {sizes}\nTYPE {types}\n"
            f"COUNT {counts}\nWIDTH {n}\nHEIGHT 1\n"
            "VIEWPOINT 0 0 0 1 0 0 0\n"
            f"POINTS {n}\nDATA ascii\n"
        )
        for i in range(n):
            row = f"{points[i, 0]:.4f} {points[i, 1]:.4f} {points[i, 2]:.4f}"
            if labels is not None:
                row += f" {int(labels[i])}"
            f.write(row + "\n")


def read_pcd(path: str) -> np.ndarray:
    """Minimal ASCII PCD reader (roundtrip for tests)."""
    with open(path) as f:
        lines = f.readlines()
    start = next(i for i, l in enumerate(lines) if l.startswith("DATA")) + 1
    return np.loadtxt(lines[start:])
