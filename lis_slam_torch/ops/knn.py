"""Exact brute-force k-nearest-neighbor search (port of
lis_slam_tpu/ops/knn.py:knn_bruteforce; replaces the reference's PCL
KdTreeFLANN::nearestKSearch, odomEstimationNode.cpp:650,766).

This is the plain version of the hand-written CUDA kernel in
ops/knn_cuda.py and its oracle. Distances are the exact
(q-r)^2 summed x, y, z in that order — not |q|^2+|r|^2-2qr, which loses
~1e-3 to cancellation — so kernel and plain version pick the same
neighbors. The voxel-hash variant of the JAX module is not ported yet.
"""

from __future__ import annotations

import torch


def sq_dist(q: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """(Q, 3) x (N, 3) -> (Q, N) squared distances, ((dx^2 + dy^2) + dz^2)
    with every product rounded (the CUDA kernel is built with
    --fmad=false to match)."""
    dx = q[:, None, 0] - r[None, :, 0]
    dy = q[:, None, 1] - r[None, :, 1]
    dz = q[:, None, 2] - r[None, :, 2]
    return dx * dx + dy * dy + dz * dz


def knn_bruteforce(query: torch.Tensor, ref: torch.Tensor,
                   ref_mask: torch.Tensor, k: int = 5, chunk: int = 4096,
                   max_sq_dist: float | None = None):
    """Exact k-NN with a running merge over reference chunks. Returns
    (sq_dists (Q,k) ascending, indices (Q,k) int32).

    Among equal distances the LOWER index wins (the running best holds
    lower indices than the chunk it is merged with, and the merge is a
    stable sort). With `max_sq_dist`, only neighbors strictly closer than
    it are kept. Unfilled slots — nothing within the cap, or fewer than k
    valid points — come back with d=+inf and index -1. Only the valid map
    points are searched (in index order, so the tie rule holds)."""
    q_n = query.shape[0]
    dev = query.device
    inf = float("inf")
    cap = inf if max_sq_dist is None else float(max_sq_dist)
    best_d = torch.full((q_n, k), inf, dtype=torch.float32, device=dev)
    best_i = torch.full((q_n, k), -1, dtype=torch.int64, device=dev)
    valid_idx = torch.nonzero(ref_mask).reshape(-1)
    for start in range(0, valid_idx.shape[0], chunk):
        idx = valid_idx[start:start + chunk]
        d = sq_dist(query, ref[idx])
        d = torch.where(d < cap, d, torch.full_like(d, inf))
        dd = torch.cat([best_d, d], dim=1)
        ii = torch.cat([best_i, idx[None, :].expand(q_n, -1)], dim=1)
        dd, sel = torch.sort(dd, dim=1, stable=True)
        best_d = dd[:, :k]
        best_i = torch.gather(ii, 1, sel[:, :k])
    best_i = torch.where(torch.isinf(best_d), torch.full_like(best_i, -1),
                         best_i)
    return best_d, best_i.to(torch.int32)
