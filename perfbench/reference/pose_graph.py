"""Plain restatement of the back end's final pose-graph solve and of the
loop-closed trajectory, in numpy.

What lis_slam_torch/graph/pose_graph.py `optimize` computes (the
reference's GTSAM back end, subMapOptmizationNode.cpp:4189-4385), written
from its mathematics: nodes X as 4x4 matrices with the right perturbation
X <- X exp(delta), twist order [rho, w]; between factors r = log(Z^-1
X_i^-1 X_j) with J_i = -Ad((X_i^-1 X_j)^-1), J_j = I; priors r = log(Z^-1
X); each scaled by its per-axis square-root information; loop edges under
a Cauchy kernel whose scale halves each sweep from `gnc_start_c` down to
`robust_c` (IRLS weights); Levenberg-Marquardt with the damping
lam (diag(H) + 1) + damping + 1e-8, a step kept only where it lowers the
cost (lam halves, floored at 1e-9; else it quadruples), and an exit once
a step moves no node by 1e-6 after the anneal has reached its last scale
and three sweeps more.

Then `correct_trajectory`: each scan takes the correction of its latest
keyframe, submap_opt @ submap_init^-1 @ kf_init @ kf_init^-1, as
`SemanticSlam.finish` does (correctPoses / transformFusion).
"""

from __future__ import annotations

import math

import numpy as np

from .numerics import Numerics


def hat(w) -> np.ndarray:
    return np.array([[0.0, -w[2], w[1]], [w[2], 0.0, -w[0]],
                     [-w[1], w[0], 0.0]])


def so3_log(R) -> np.ndarray:
    tr = R[0, 0] + R[1, 1] + R[2, 2]
    theta = math.acos(min(1.0, max(-1.0, (tr - 1.0) / 2.0)))
    if theta < 1e-6:
        scale = 0.5 + theta * theta / 12.0
    else:
        scale = theta / (2.0 * max(math.sin(theta), 1e-12))
    W = R - R.T
    return scale * np.array([W[2, 1], W[0, 2], W[1, 0]])


def se3_exp(xi) -> np.ndarray:
    rho, w = xi[:3], xi[3:]
    t2 = float(w @ w)
    if t2 < 1e-12:
        a, b, c = 1.0 - t2 / 6.0, 0.5 - t2 / 24.0, 1.0 / 6.0 - t2 / 120.0
    else:
        th = math.sqrt(t2)
        a = math.sin(th) / th
        b = (1.0 - math.cos(th)) / t2
        c = (1.0 - a) / t2
    W = hat(w)
    W2 = W @ W
    T = np.eye(4)
    T[:3, :3] = np.eye(3) + a * W + b * W2
    T[:3, 3] = (np.eye(3) + b * W + c * W2) @ rho
    return T


def se3_log(T) -> np.ndarray:
    w = so3_log(T[:3, :3])
    t2 = float(w @ w)
    half = math.sqrt(max(t2, 1e-24)) / 2.0
    if t2 < 1e-12:
        cot = 1.0 / 12.0 + t2 / 720.0
    else:
        cot = (1.0 - half * math.cos(half) / max(math.sin(half), 1e-12)) / t2
    W = hat(w)
    Vinv = np.eye(3) - 0.5 * W + cot * (W @ W)
    return np.concatenate([Vinv @ T[:3, 3], w])


def inv(T) -> np.ndarray:
    out = np.eye(4)
    out[:3, :3] = T[:3, :3].T
    out[:3, 3] = -T[:3, :3].T @ T[:3, 3]
    return out


def adjoint(T) -> np.ndarray:
    R = T[:3, :3]
    A = np.zeros((6, 6))
    A[:3, :3] = R
    A[:3, 3:] = hat(T[:3, 3]) @ R
    A[3:, 3:] = R
    return A


class _Graph:
    def __init__(self, num: Numerics, nodes, edges, priors):
        self.num = num
        self.nodes = [num.arr(n) for n in nodes]
        self.edges = [(i, j, num.arr(z), num.arr(w), bool(r))
                      for i, j, z, w, r in edges]
        self.priors = [(i, num.arr(z), num.arr(w)) for i, z, w in priors]

    def mm(self, a, b):
        return self.num.matmul(a, b)

    def residuals(self, nodes):
        dt = self.num.dtype
        out_e, out_p = [], []
        for i, j, z, w, robust in self.edges:
            rel = self.mm(inv(nodes[i]).astype(dt), nodes[j])
            r = se3_log(self.mm(inv(z).astype(dt), rel)).astype(dt)
            Ji = -adjoint(inv(rel)).astype(dt)
            out_e.append((i, j, r * w, Ji * w[:, None],
                          np.diag(w).astype(dt), robust))
        for i, z, w in self.priors:
            r = se3_log(self.mm(inv(z).astype(dt), nodes[i])).astype(dt)
            out_p.append((i, r * w, np.diag(w).astype(dt)))
        return out_e, out_p

    @staticmethod
    def cost(res_e, res_p, c: float) -> float:
        total = 0.0
        for _i, _j, r, _a, _b, robust in res_e:
            e2 = float(r @ r)
            total += c * c * math.log1p(e2 / (c * c)) if robust else e2
        for _i, r, _J in res_p:
            total += float(r @ r)
        return total


def optimize(nodes, edges, priors, damping: float, iterations: int,
             robust_c: float, gnc_start_c: float,
             num: Numerics | None = None) -> np.ndarray:
    """The optimized nodes (n, 4, 4) of the graph the program solved."""
    num = num or Numerics()
    dt = num.dtype
    G = _Graph(num, nodes, edges, priors)
    n = len(G.nodes)
    X = list(G.nodes)
    min_sweeps = min(iterations, int(math.ceil(math.log2(
        max(gnc_start_c / robust_c, 1.0)))) + 3)
    lam = 1e-4
    for it in range(iterations):
        c = max(robust_c, gnc_start_c * 0.5 ** it)
        res_e, res_p = G.residuals(X)
        cost = G.cost(res_e, res_p, c)
        H = np.zeros((6 * n, 6 * n), dt)
        b = np.zeros(6 * n, dt)
        for i, j, r, Ji, Jj, robust in res_e:
            s = (math.sqrt(1.0 / (1.0 + float(r @ r) / (c * c))) if robust
                 else 1.0)
            r, Ji, Jj = r * s, Ji * s, Jj * s
            si, sj = slice(6 * i, 6 * i + 6), slice(6 * j, 6 * j + 6)
            H[si, si] += num.matmul(Ji.T, Ji, store=False)
            H[sj, sj] += num.matmul(Jj.T, Jj, store=False)
            H[si, sj] += num.matmul(Ji.T, Jj, store=False)
            H[sj, si] += num.matmul(Jj.T, Ji, store=False)
            b[si] += num.matmul(Ji.T, r, store=False)
            b[sj] += num.matmul(Jj.T, r, store=False)
        for i, r, Jp in res_p:
            si = slice(6 * i, 6 * i + 6)
            H[si, si] += num.matmul(Jp.T, Jp, store=False)
            b[si] += num.matmul(Jp.T, r, store=False)
        Hd = H + np.diag(damping + lam * (np.diag(H) + 1.0) + 1e-8)
        delta = -np.linalg.solve(Hd.astype(dt), b.astype(dt)).reshape(n, 6)
        cand = [num.matmul(X[k], se3_exp(delta[k])) for k in range(n)]
        r2e, r2p = G.residuals(cand)
        if G.cost(r2e, r2p, c) < cost:
            X = cand
            lam = max(lam * 0.5, 1e-9)
        else:
            lam = lam * 4.0
        if it + 1 >= min_sweeps and float(np.max(np.abs(delta))) < 1e-6:
            break
    return np.stack([np.asarray(x, np.float64) for x in X])


def correct_trajectory(raw_poses, kf_scan_ids, kf_pose_init, kf_submap,
                       submap_pose_init, submap_opt, pose_to_matrix,
                       matrix_to_pose) -> np.ndarray:
    """Each scan's loop-closed pose: its raw pose under the correction of
    the latest keyframe at or before it that belongs to a submap."""
    out = np.array(raw_poses, np.float64)
    delta = np.eye(4)
    ptr = -1
    for i in range(len(out)):
        while ptr + 1 < len(kf_scan_ids) and kf_scan_ids[ptr + 1] <= i:
            ptr += 1
            s = kf_submap[ptr]
            if s >= 0:
                corr = submap_opt[s] @ np.linalg.inv(submap_pose_init[s]) \
                    @ kf_pose_init[ptr]
                delta = corr @ np.linalg.inv(kf_pose_init[ptr])
        out[i] = matrix_to_pose(delta @ pose_to_matrix(out[i]))
    return out
