"""Trajectory export and metrics (port of lis_slam_tpu/pipeline/
trajectory.py, in numpy over utils/se3_np): KITTI export (the reference's
transformFusion writer, subMapOptmizationNode.cpp:5079-5179),
re-expression relative to the first pose, ATE RMSE, RPE."""

from __future__ import annotations

import numpy as np

from ..utils import se3_np


def _to_mats(poses6: np.ndarray) -> np.ndarray:
    return np.stack([se3_np.pose_to_matrix(p)
                     for p in np.asarray(poses6, np.float64)])


def poses_to_kitti(poses6: np.ndarray) -> np.ndarray:
    """(N, 6) [roll,pitch,yaw,x,y,z] -> (N, 12) KITTI rows, first-pose
    normalized (T0^-1 @ T_i). The matrices are built from float32 poses,
    as the JAX package does."""
    T = _to_mats(np.asarray(poses6, np.float32))
    rel = np.einsum("ij,njk->nik", np.linalg.inv(T[0]), T)
    return rel[:, :3, :].reshape(len(poses6), 12)


def write_kitti(path: str, poses6: np.ndarray) -> None:
    with open(path, "w") as f:
        for r in poses_to_kitti(poses6):
            f.write(" ".join(f"{v:.9e}" for v in r) + "\n")


def relative_to_first(poses6: np.ndarray) -> np.ndarray:
    """Re-express a trajectory relative to its first pose (odometry starts at
    identity, ground truth usually doesn't)."""
    T = _to_mats(poses6)
    rel = np.einsum("ij,njk->nik", np.linalg.inv(T[0]), T)
    return np.stack([se3_np.matrix_to_pose(t) for t in rel])


def align_umeyama(est: np.ndarray, gt: np.ndarray):
    """SE(3) alignment (no scale) of est trajectory onto gt (N, 3) each."""
    mu_e, mu_g = est.mean(0), gt.mean(0)
    U, _, Vt = np.linalg.svd((est - mu_e).T @ (gt - mu_g))
    S = np.eye(3)
    if np.linalg.det(U @ Vt) < 0:
        S[2, 2] = -1
    R = (U @ S @ Vt).T
    return R, mu_g - R @ mu_e


def ate_rmse(est6: np.ndarray, gt6: np.ndarray, align: bool = True) -> float:
    """Absolute trajectory error (RMSE over positions, optional SE3 align)."""
    e = np.asarray(est6)[:, 3:6].astype(np.float64)
    g = np.asarray(gt6)[:, 3:6].astype(np.float64)
    if e.shape != g.shape:
        raise ValueError(f"trajectory shapes differ: {e.shape} vs {g.shape}")
    if align:
        R, t = align_umeyama(e, g)
        e = e @ R.T + t
    return float(np.sqrt(np.mean(np.sum((e - g) ** 2, axis=1))))


def rpe(est6: np.ndarray, gt6: np.ndarray, delta: int = 1):
    """Relative pose error: per-step translational drift (m) and rotational
    drift (deg), RMSE over the sequence."""
    Te, Tg = _to_mats(est6), _to_mats(gt6)
    dts, drs = [], []
    for i in range(len(Te) - delta):
        de = np.linalg.inv(Te[i]) @ Te[i + delta]
        dg = np.linalg.inv(Tg[i]) @ Tg[i + delta]
        err = np.linalg.inv(dg) @ de
        dts.append(np.linalg.norm(err[:3, 3]))
        c = np.clip((np.trace(err[:3, :3]) - 1) / 2, -1, 1)
        drs.append(np.degrees(np.arccos(c)))
    return (float(np.sqrt(np.mean(np.square(dts)))),
            float(np.sqrt(np.mean(np.square(drs)))))
