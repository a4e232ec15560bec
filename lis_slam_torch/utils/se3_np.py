"""Host-side (numpy) SE(3) pose helpers.

Same conventions as utils/se3.py (R = Rz(yaw) Ry(pitch) Rx(roll), the
pcl::getTransformation convention used throughout the reference). Host
bookkeeping must NOT use the jnp versions: every eager device op costs a
dispatch (and a first-use compile) — pose composition on the host is pure
numpy.
"""

from __future__ import annotations

import numpy as np


def pose_to_matrix(pose6: np.ndarray) -> np.ndarray:
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


def matrix_to_pose(T: np.ndarray) -> np.ndarray:
    R = T[:3, :3]
    pitch = np.arcsin(np.clip(-R[2, 0], -1.0, 1.0))
    roll = np.arctan2(R[2, 1], R[2, 2])
    yaw = np.arctan2(R[1, 0], R[0, 0])
    return np.array([roll, pitch, yaw, T[0, 3], T[1, 3], T[2, 3]])


def transform_points(T: np.ndarray, pts: np.ndarray) -> np.ndarray:
    return pts @ T[:3, :3].T + T[:3, 3]
