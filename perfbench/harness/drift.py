"""The injected odometry drift (frozen copy of chip_smoke.py:1182-1191
`_slam_drift_hook`, after bench.py:216-221): a yaw error about the world
origin growing `per_scan` rad a scan, composed onto the front-end pose.
Restated in numpy, importing nothing of lis_slam_torch."""

from __future__ import annotations

import numpy as np

from .render import pose_to_matrix_np


def matrix_to_pose_np(T: np.ndarray) -> np.ndarray:
    R = T[:3, :3]
    pitch = np.arcsin(np.clip(-R[2, 0], -1.0, 1.0))
    roll = np.arctan2(R[2, 1], R[2, 2])
    yaw = np.arctan2(R[1, 0], R[0, 0])
    return np.array([roll, pitch, yaw, T[0, 3], T[1, 3], T[2, 3]])


def drift_hook(per_scan: float):
    """pose_hook(pose6, idx) -> pose6 for SemanticSlam."""
    def hook(pose6, idx):
        th = per_scan * idx
        c, s = np.cos(th), np.sin(th)
        Td = np.eye(4)
        Td[:2, :2] = [[c, -s], [s, c]]
        return matrix_to_pose_np(Td @ pose_to_matrix_np(pose6))
    return hook
