"""Trajectory metrics (port of lis_slam_tpu/pipeline/trajectory.py, in
numpy over utils/se3_np): re-expression relative to the first pose, ATE
RMSE, RPE."""

from __future__ import annotations

import numpy as np

from ..utils import se3_np


def _to_mats(poses6: np.ndarray) -> np.ndarray:
    return np.stack([se3_np.pose_to_matrix(p)
                     for p in np.asarray(poses6, np.float64)])


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
