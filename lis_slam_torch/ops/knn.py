"""Exact brute-force k-nearest-neighbor search (port of
lis_slam_tpu/ops/knn.py:knn_bruteforce; replaces the reference's PCL
KdTreeFLANN::nearestKSearch, odomEstimationNode.cpp:650,766).

This is the plain version of the hand-written CUDA kernel in
ops/knn_cuda.py and its oracle. Distances are the exact
(q-r)^2 summed x, y, z in that order — not |q|^2+|r|^2-2qr, which loses
~1e-3 to cancellation — so kernel and plain version pick the same
neighbors.

`VoxelHashMap` / `build_hash` / `knn_hash` are the spatial-hash k-NN of
the JAX module (bucket-sorted points, 27-cell probe), used by the loop
verification ICP. Plain PyTorch: the JAX package has no kernel for it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .pretreatment import sum_sq3


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


# ---------------------------------------------------------------------------
# Voxel-hash variant
# ---------------------------------------------------------------------------

_INF = 3e38  # the JAX module's sentinel distance for empty probe slots
_U32 = 0xFFFFFFFF


class VoxelHashMap(NamedTuple):
    """Bucket-sorted point store for the 27-cell k-NN probe."""

    points: torch.Tensor  # (N, 3) sorted by bucket hash
    point_id: torch.Tensor  # (N,) int64 original index into the map buffer
    bucket_start: torch.Tensor  # (T+1,) CSR offsets into the sorted arrays
    cell_size: float

    @property
    def table_size(self) -> int:
        return self.bucket_start.shape[0] - 1


def _hash_cells(cx, cy, cz, table_size: int) -> torch.Tensor:
    """The JAX module's uint32 spatial hash of int32 cell coords, in int64:
    each coordinate wraps to 32 bits as `astype(uint32)` does, and each
    product is masked back to 32 bits (uint32 multiplication wraps)."""
    def term(c, mult):
        return ((c.to(torch.int64) & _U32) * mult) & _U32

    h = (term(cx, 73856093) ^ term(cy, 19349663) ^ term(cz, 83492791))
    return torch.remainder(h, table_size)


def build_hash(points: torch.Tensor, mask: torch.Tensor,
               cell_size: float = 1.0, table_size: int = 1 << 16
               ) -> VoxelHashMap:
    """Sort the masked points by cell hash (stable, padding last) and
    record each bucket's start."""
    cells = torch.floor(points / cell_size).to(torch.int32)
    h = _hash_cells(cells[:, 0], cells[:, 1], cells[:, 2], table_size)
    h = torch.where(mask, h, torch.full_like(h, table_size))
    h_sorted, order = torch.sort(h, stable=True)
    starts = torch.searchsorted(
        h_sorted, torch.arange(table_size + 1, device=points.device))
    return VoxelHashMap(points=points[order], point_id=order,
                        bucket_start=starts, cell_size=float(cell_size))


_NEIGHBOR_OFFSETS = [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1)
                     for dz in (-1, 0, 1)]


def knn_hash(query: torch.Tensor, hmap: VoxelHashMap, k: int = 5,
             bucket_cap: int = 16):
    """k-NN among the first `bucket_cap` points of each of the 27 buckets
    around each query's cell (exact within cell_size up to bucket
    occupancy). Returns (sq_dists (Q,k) ascending, original indices (Q,k)
    int64); empty slots hold d = 3e38 and index point_id[0], as in the JAX
    module. Among equal distances the lower probe slot wins (lax.top_k)."""
    q_n = query.shape[0]
    dev = query.device
    qcell = torch.floor(query / hmap.cell_size).to(torch.int32)
    offs = torch.tensor(_NEIGHBOR_OFFSETS, dtype=torch.int32, device=dev)
    cc = qcell[:, None, :] + offs[None, :, :]  # (Q, 27, 3)
    hb = _hash_cells(cc[..., 0], cc[..., 1], cc[..., 2], hmap.table_size)
    start = hmap.bucket_start[hb]
    end = hmap.bucket_start[hb + 1]
    sl = start[..., None] + torch.arange(bucket_cap, device=dev)
    ok = sl < end[..., None]
    ci = torch.where(ok, sl, torch.zeros_like(sl)).reshape(q_n, -1)
    cv = ok.reshape(q_n, -1)
    d = sum_sq3(hmap.points[ci] - query[:, None, :])
    d = torch.where(cv, d, torch.full_like(d, _INF))
    d, sel = torch.sort(d, dim=1, stable=True)
    idx = torch.gather(ci, 1, sel[:, :k])
    return d[:, :k], hmap.point_id[idx]
