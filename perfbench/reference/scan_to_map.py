"""Plain restatement of the front end's scan-to-map solve, in numpy.

What lis_slam_torch/ops/scan_match.py `scan_to_map` computes (LOAM
point-to-line and point-to-plane Gauss-Newton, after
odomEstimationNode.cpp cornerOptimization :633-747, surfOptimization
:749-827, LMOptimization :829-974), written from its mathematics:

- neighbours: the exact `cache_k` nearest map points within 2 m (a k-d
  tree), fetched at the guess and again whenever the pose has moved more
  than the refresh distance or angle from where they were fetched; each
  iteration re-ranks them at the current pose and keeps the 5 nearest;
- a corner query is kept where its 5th neighbour lies within the gate,
  the neighbours' scatter is a line (largest eigenvalue over 3 x the
  middle one) and the damped weight s = 1 - 0.9 d exceeds 0.1; its row is
  the point-to-line distance and its gradient;
- a surf query is kept where its 5th neighbour lies within the gate, all
  5 neighbours lie within the plane tolerance of their total-least-squares
  plane and s = 1 - 0.9 |d| / |p|^(1/2) exceeds 0.1;
- each iteration solves (J^T J + 1e-9 I) x = -J^T r for the additive
  update of [roll, pitch, yaw, x, y, z], projects x off the directions of
  J^T J whose eigenvalue is under the degeneracy threshold, zeroes it
  with fewer rows than the minimum, and stops once the step is under both
  convergence limits or after `max_iterations`.

The program runs this in float32 with its kernels K1 (the neighbours) and
K2 (the rows and their sums); the reference in float64, or in the
control's precision (numerics.py: every stored value in bfloat16,
the arithmetic in float32). It imports nothing of the program.
"""

from __future__ import annotations

import numpy as np
from scipy.spatial import cKDTree

from .numerics import Numerics

_BIG = 3e38


def euler_to_rot(rpy) -> np.ndarray:
    r, p, y = (float(v) for v in rpy)
    cr, sr, cp, sp = np.cos(r), np.sin(r), np.cos(p), np.sin(p)
    cy, sy = np.cos(y), np.sin(y)
    return np.array([[cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr],
                     [sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr],
                     [-sp, cp * sr, cp * cr]])


def rotation_jacobians(rpy) -> np.ndarray:
    """d(Rz Ry Rx)/d roll, pitch, yaw: (3, 3, 3)."""
    r, p, y = (float(v) for v in rpy)
    cr, sr, cp, sp = np.cos(r), np.sin(r), np.cos(p), np.sin(p)
    cy, sy = np.cos(y), np.sin(y)
    Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    dRx = np.array([[0, 0, 0], [0, -sr, -cr], [0, cr, -sr]])
    dRy = np.array([[-sp, 0, cp], [0, 0, 0], [-cp, 0, -sp]])
    dRz = np.array([[-sy, -cy, 0], [cy, -sy, 0], [0, 0, 0]])
    return np.stack([Rz @ Ry @ dRx, Rz @ dRy @ Rx, dRz @ Ry @ Rx])


class _Cloud:
    """A query cloud with its neighbour cache."""

    def __init__(self, pts, map_pts, k: int):
        self.pts = pts
        self.map = map_pts
        self.tree = cKDTree(map_pts) if len(map_pts) else None
        self.k = k
        self.cand = None
        self.cand_ok = None

    def fetch(self, world):
        n = len(world)
        if self.tree is None or n == 0:
            self.cand = np.zeros((n, self.k, 3))
            self.cand_ok = np.zeros((n, self.k), bool)
            return
        k = min(self.k, len(self.map))
        d, idx = self.tree.query(world, k=k, distance_upper_bound=2.0)
        d, idx = d.reshape(n, k), idx.reshape(n, k)
        ok = np.isfinite(d) & (d * d < 4.0)
        safe = np.where(ok, idx, 0)
        cand = np.where(ok[..., None], self.map[safe], 0.0)
        if k < self.k:
            pad = self.k - k
            cand = np.concatenate([cand, np.zeros((n, pad, 3))], 1)
            ok = np.concatenate([ok, np.zeros((n, pad), bool)], 1)
        self.cand, self.cand_ok = cand, ok


def _nearest5(num: Numerics, world, cloud: _Cloud):
    cand = num.arr(cloud.cand)
    diff = cand - world[:, None, :]
    d = np.sum(diff * diff, axis=-1)
    d = np.where(cloud.cand_ok, d, _BIG)
    order = np.argsort(d, axis=-1, kind="stable")[:, :5]
    return (np.take_along_axis(d, order, -1),
            np.take_along_axis(cand, order[..., None], 1))


def corner_rows(num: Numerics, world, nn_d, near, m: dict):
    gate = nn_d[:, 4] < m["nn_max_sq_dist"]
    center = near.mean(axis=1)
    diff = near - center[:, None, :]
    cov = num.einsum("nki,nkj->nij", diff, diff, store=False) / 5.0
    evals, evecs = np.linalg.eigh(cov.astype(num.dtype))
    is_line = evals[:, 2] > m["eigen_ratio_line"] * evals[:, 1]
    u = evecs[:, :, 2]
    cx = np.cross(world - center, u)
    dist = np.linalg.norm(cx, axis=-1)
    grad = np.cross(u, cx) / np.maximum(dist, 1e-12)[:, None]
    s = 1.0 - m["residual_damping"] * np.abs(dist)
    ok = gate & is_line & (s > m["min_residual_weight"])
    return s[:, None] * grad, s * dist, ok


def surf_rows(num: Numerics, world, nn_d, near, m: dict):
    gate = nn_d[:, 4] < m["nn_max_sq_dist"]
    c = near.mean(axis=1)
    diff = near - c[:, None, :]
    cov = num.einsum("nki,nkj->nij", diff, diff, store=False)
    _evals, evecs = np.linalg.eigh(cov.astype(num.dtype))
    n = evecs[:, :, 0]
    d = -np.sum(n * c, axis=-1)
    plane_res = np.abs(num.einsum("nkj,nj->nk", near, n, store=False)
                       + d[:, None])
    plane_ok = np.all(plane_res <= m["plane_fit_tolerance"], axis=-1)
    pd2 = np.sum(world * n, axis=-1) + d
    damp = np.sqrt(np.sqrt(np.sum(world * world, axis=-1) + 1e-12))
    s = 1.0 - m["residual_damping"] * np.abs(pd2) / np.maximum(damp, 1e-6)
    ok = gate & plane_ok & (s > m["min_residual_weight"])
    return s[:, None] * n, s * pd2, ok


def solve_step(num: Numerics, pose, H, g, n_valid: int, m: dict):
    """The pose after one iteration and whether it converged."""
    dt = num.dtype
    x = np.linalg.solve(H.astype(dt) + dt(1e-9) * np.eye(6, dtype=dt),
                        g.astype(dt))
    evals, evecs = np.linalg.eigh(H.astype(dt))
    keep = (evals >= m["degeneracy_eigen_threshold"]).astype(dt)
    if np.any(keep < 0.5):
        x = ((evecs * keep) @ evecs.T) @ x
    enough = n_valid >= m["min_valid_points"]
    if not enough:
        x = np.zeros_like(x)
    delta_r = float(np.rad2deg(np.linalg.norm(x[:3])))
    delta_t = float(100.0 * np.linalg.norm(x[3:]))
    converged = ((delta_r < m["converge_delta_r_deg"]
                  and delta_t < m["converge_delta_t_cm"]) or not enough)
    return (pose + x).astype(num.dtype), converged


def scan_to_map(rec: dict, m: dict, num: Numerics | None = None):
    """Solve one captured front-end problem again. `rec` holds host numpy
    copies of what the program was handed (harness/probes.py): pose0,
    corner_pts/mask, surf_pts/mask, corner_map/mask, surf_map/mask, and
    either max_iterations (the host loop: fetch again once the pose has
    moved past the refresh distance or angle, stop on convergence) or
    `schedule` = (n_iters, refresh_iters) (the scheduled solver of the
    batched replay: fetch again before each iteration in refresh_iters,
    hold the pose once converged, n_iters at most). `m` holds the matching
    parameters. Returns (pose6, iterations)."""
    num = num or Numerics()
    cq = num.arr(rec["corner_pts"][rec["corner_mask"]])
    sq = num.arr(rec["surf_pts"][rec["surf_mask"]])
    # the k-d trees search in float64 in both precisions
    clouds = [_Cloud(cq, np.asarray(rec["corner_map"][rec["corner_map_mask"]],
                                    np.float64), m["nn_cache_k"]),
              _Cloud(sq, np.asarray(rec["surf_map"][rec["surf_map_mask"]],
                                    np.float64), m["nn_cache_k"])]
    pose = num.arr(rec["pose0"])

    def world(cloud, pose):
        R = num.arr(euler_to_rot(pose[:3]))
        return num.einsum("ij,nj->ni", R, cloud.pts) + pose[3:]

    def fetch(pose):
        for c in clouds:
            c.fetch(np.asarray(world(c, pose), np.float64))
        return pose.copy()

    cache_pose = fetch(pose)
    sched = rec.get("schedule")
    n_iters = rec["max_iterations"] if sched is None else sched[0]
    it, converged = 0, False
    while it < n_iters and not converged:
        if sched is not None:
            again = it in sched[1]
        else:
            again = (np.linalg.norm(pose[3:] - cache_pose[3:])
                     > m["nn_cache_refresh_dist"]
                     or np.linalg.norm(pose[:3] - cache_pose[:3])
                     > m["nn_cache_refresh_rot"])
        if again:
            cache_pose = fetch(pose)
        rows = []
        for c, fn in zip(clouds, (corner_rows, surf_rows)):
            w = world(c, pose)
            nn_d, near = _nearest5(num, w, c)
            coeff, res, ok = fn(num, w, nn_d, near, m)
            rows.append((c.pts[ok], coeff[ok], res[ok]))
        p = np.concatenate([r[0] for r in rows])
        coeff = np.concatenate([r[1] for r in rows])
        res = np.concatenate([r[2] for r in rows])
        M = num.arr(rotation_jacobians(pose[:3]))
        j_rot = num.einsum("mj,ajk,mk->ma", coeff, M, p, store=False)
        J = np.concatenate([j_rot, coeff], axis=1)
        H = num.einsum("mi,mj->ij", J, J, store=False)
        g = num.einsum("mi,m->i", J, -res, store=False)
        pose, converged = solve_step(num, pose, H, g, len(res), m)
        it += 1
    return np.asarray(pose, np.float64), it
