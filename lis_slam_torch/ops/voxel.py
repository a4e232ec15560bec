"""Fixed-capacity voxel-grid downsampling and the aged sliding-window map
merge (port of lis_slam_tpu/ops/voxel.py; replaces pcl::VoxelGrid uses,
odomEstimationNode.cpp:185-207).

Voxel keys are int64 here: the JAX keys are uint32, and torch's uint32
lacks shifts and sorts on CUDA. Every key fits in 32 bits, so int64 sorts
them in the same order, and the invalid sentinel stays 0xFFFFFFFF.
"""

from __future__ import annotations

import torch

_SENTINEL = 0xFFFFFFFF


def _cell_offsets(points: torch.Tensor, mask: torch.Tensor, leaf: float):
    """Integer voxel coords relative to the masked cloud's min corner."""
    c = torch.floor(points / leaf).to(torch.int32)
    cmin = torch.min(torch.where(mask[:, None], c,
                                 torch.full_like(c, 2**30)), dim=0).values
    return (c - cmin).to(torch.int64)


def _voxel_key(points: torch.Tensor, mask: torch.Tensor,
               leaf: float) -> torch.Tensor:
    """Exact packed key, collision-free within a 4096 x 4096 x 255 cell
    window around the cloud's min corner (stragglers clamp to the edge)."""
    d = _cell_offsets(points, mask, leaf)
    hi = torch.tensor([4095, 4095, 254], dtype=torch.int64,
                      device=points.device)
    d = torch.minimum(torch.clamp(d, min=0), hi)
    return d[:, 0] | (d[:, 1] << 12) | (d[:, 2] << 24)


def _spread3(x: torch.Tensor) -> torch.Tensor:
    """Spread 10 bits to every 3rd position (morton interleave helper)."""
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def _voxel_key_morton(points: torch.Tensor, mask: torch.Tensor,
                      leaf: float) -> torch.Tensor:
    """Morton (Z-order) voxel key, 10 bits/axis relative to the cloud's min
    corner: unique within a 1024^3-cell window and spatially coherent, so
    buffers sorted by it keep map neighbors together."""
    d = torch.clamp(_cell_offsets(points, mask, leaf), 0, 1023)
    return (_spread3(d[:, 0]) | (_spread3(d[:, 1]) << 1)
            | (_spread3(d[:, 2]) << 2))


def _masked_key(key: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return torch.where(mask, key, torch.full_like(key, _SENTINEL))


def _run_starts(hs: torch.Tensor):
    """(is_first, is_last) of each run of equal sorted keys, sentinel runs
    excluded."""
    change = hs[1:] != hs[:-1]
    is_first = torch.ones_like(hs, dtype=torch.bool)
    is_first[1:] = change
    is_last = torch.ones_like(hs, dtype=torch.bool)
    is_last[:-1] = change
    valid = hs != _SENTINEL
    return is_first & valid, is_last & valid


def _dest(sel: torch.Tensor, seg: torch.Tensor, capacity: int):
    return torch.where(sel & (seg < capacity), seg,
                       torch.full_like(seg, capacity)).to(torch.int64)


def voxel_downsample(points: torch.Tensor, mask: torch.Tensor, leaf: float,
                     capacity: int, payloads: tuple = ()):
    """One point per voxel: the FIRST in input order (stable sort on the
    key). Returns (points (C,3), mask (C,), count[, payloads (C,) ...]):
    each per-point float column of `payloads` comes out aligned with the
    kept points (0 in empty slots). The centroid variant of the JAX package
    is not ported."""
    h = _masked_key(_voxel_key(points, mask, leaf), mask)
    hs, order = torch.sort(h, stable=True)
    is_new, _ = _run_starts(hs)
    seg = torch.cumsum(is_new.to(torch.int32), 0) - 1
    dest = _dest(is_new, seg, capacity)
    k = torch.clamp(torch.sum(is_new.to(torch.int32)), max=capacity)
    out_mask = torch.arange(capacity, device=points.device) < k
    cols = torch.cat([points] + [p.to(points.dtype)[:, None]
                                 for p in payloads], dim=1)
    buf = torch.zeros((capacity + 1, cols.shape[1]), dtype=points.dtype,
                      device=points.device)
    buf[dest] = cols[order]
    buf = torch.where(out_mask[:, None], buf[:capacity],
                      torch.zeros_like(buf[:capacity]))
    return (buf[:, :3], out_mask, k) + tuple(
        buf[:, 3 + i] for i in range(len(payloads)))


def voxel_merge_aged(new_points: torch.Tensor, new_mask: torch.Tensor,
                     map_points: torch.Tensor, map_age: torch.Tensor,
                     map_mask: torch.Tensor, kf_index: int, window: int,
                     leaf: float, capacity: int, anchor: str = "first",
                     new_flag: torch.Tensor | None = None,
                     map_flag: torch.Tensor | None = None):
    """Incremental sliding-window map update (merge-last-K-keyframes +
    voxel-downsample semantics, odomEstimationNode.cpp:185-207): a voxel is
    in the map iff some keyframe in the last `window` observed it.

    The new cloud is concatenated IN FRONT of the map and one stable sort
    on the morton key dedups; the map holds <= 1 point per voxel, so within
    a key run the LAST element is the anchored map point when one exists
    (anchor="first") and the FIRST is the newest observation
    (anchor="newest", and the age either way). The output stays
    morton-ordered.

    With `new_flag`/`map_flag`, a per-point bool rides the merge and
    follows its POINT (the anchored one), e.g. the dynamic-class flag of
    the semantic local map. Returns (points (C,3), age (C,), mask (C,)
    [, flag (C,)])."""
    if anchor not in ("first", "newest"):
        raise ValueError(f"anchor must be 'first'|'newest', got {anchor!r}")
    dev = new_points.device
    alive = map_mask & (map_age > kf_index - window)
    pts = torch.cat([new_points, map_points], dim=0)
    age = torch.cat([
        torch.full((new_points.shape[0],), kf_index, dtype=torch.int32,
                   device=dev), map_age])
    mask = torch.cat([new_mask, alive])
    h = _masked_key(_voxel_key_morton(pts, mask, leaf), mask)
    hs, order = torch.sort(h, stable=True)
    is_first, is_last = _run_starts(hs)
    seg = torch.cumsum(is_first.to(torch.int32), 0) - 1
    is_anchor = is_last if anchor == "first" else is_first
    k = torch.clamp(torch.sum(is_first.to(torch.int32)), max=capacity)
    out_mask = torch.arange(capacity, device=dev) < k
    buf = torch.zeros((capacity + 1, 3), dtype=pts.dtype, device=dev)
    buf[_dest(is_anchor, seg, capacity)] = pts[order]
    out_pts = torch.where(out_mask[:, None], buf[:capacity],
                          torch.zeros_like(buf[:capacity]))
    out_age = torch.zeros((capacity + 1,), dtype=torch.int32, device=dev)
    out_age[_dest(is_first, seg, capacity)] = age[order]
    out_age = torch.where(out_mask, out_age[:capacity],
                          torch.full_like(out_age[:capacity], -(10**9)))
    if new_flag is None:
        return out_pts, out_age, out_mask
    flag = torch.cat([new_flag, map_flag])
    out_flag = torch.zeros((capacity + 1,), dtype=torch.bool, device=dev)
    out_flag[_dest(is_anchor, seg, capacity)] = flag[order]
    return out_pts, out_age, out_mask, out_flag[:capacity] & out_mask


def compact_masked(points: torch.Tensor, mask: torch.Tensor, capacity: int):
    """Pack masked rows of (N, 3) into a (capacity, 3) buffer (order kept).
    Returns (points, mask)."""
    pos = torch.cumsum(mask.to(torch.int32), 0) - 1
    buf = torch.zeros((capacity + 1, 3), dtype=points.dtype,
                      device=points.device)
    buf[_dest(mask, pos, capacity)] = points
    cnt = torch.clamp(torch.sum(mask.to(torch.int32)), max=capacity)
    return buf[:capacity], torch.arange(capacity, device=points.device) < cnt
