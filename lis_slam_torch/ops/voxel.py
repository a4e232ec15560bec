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
    """Integer voxel coords relative to the masked cloud's min corner, per
    cloud of (..., P, 3). The min is a scatter-min into one row per cloud,
    the same launches for any number of clouds (a CUDA min-reduction picks
    its grid, and whether it needs a zeroed scratch, by the output count)."""
    c = torch.floor(points / leaf).to(torch.int32)
    masked = torch.where(mask[..., None], c, torch.full_like(c, 2**30))
    cmin = torch.full(c.shape[:-2] + (1, 3), 2**30, dtype=torch.int32,
                      device=c.device)
    row = torch.zeros((1,) * c.dim(), dtype=torch.int64, device=c.device)
    cmin.scatter_reduce_(-2, row.expand(c.shape), masked, "amin")
    return (c - cmin).to(torch.int64)


def _voxel_key(points: torch.Tensor, mask: torch.Tensor,
               leaf: float) -> torch.Tensor:
    """Exact packed key, collision-free within a 4096 x 4096 x 255 cell
    window around the cloud's min corner (stragglers clamp to the edge)."""
    d = _cell_offsets(points, mask, leaf)
    dx, dy, dz = (d[..., i].clamp(0, hi)
                  for i, hi in enumerate((4095, 4095, 254)))
    return dx | (dy << 12) | (dz << 24)


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
    return (_spread3(d[..., 0]) | (_spread3(d[..., 1]) << 1)
            | (_spread3(d[..., 2]) << 2))


def _masked_key(key: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return torch.where(mask, key, torch.full_like(key, _SENTINEL))


def _run_starts(hs: torch.Tensor):
    """(is_first, is_last) of each run of equal sorted keys along the last
    axis, sentinel runs excluded."""
    change = hs[..., 1:] != hs[..., :-1]
    edge = torch.ones_like(hs[..., :1], dtype=torch.bool)
    valid = hs != _SENTINEL
    return (torch.cat([edge, change], dim=-1) & valid,
            torch.cat([change, edge], dim=-1) & valid)


_SMALL_SORT = 4096  # torch.sort's in-place per-row sort up to this length


def lane_sort(key: torch.Tensor):
    """Stable ascending sort of each lane of `key` (B, N), int64 values in
    [0, 2^32), with the same kernels for one lane as for many: rows of at
    most _SMALL_SORT keys sort in place per row (one launch for any B);
    longer ones as one flat sort of lane-offset keys (lane << 32 | key),
    since a batched torch.sort of long rows switches algorithm with the
    lane count (one segment or several) and a flat one of few keys to the
    per-row sort. Returns (sorted keys (B, N), each lane's order (B, N)
    int64)."""
    b, n = key.shape
    if n <= _SMALL_SORT:
        return torch.sort(key, dim=-1, stable=True)
    lane = torch.arange(b, device=key.device)[:, None]
    s, order = torch.sort(((lane << 32) | key).reshape(-1), stable=True)
    return (s & 0xFFFFFFFF).reshape(b, n), order.reshape(b, n) - lane * n


def lane_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive cumsum along each lane of integer `x` (B, N), int64: one
    flat scan less each lane's start (a batched torch.cumsum takes another
    algorithm for one lane than for many)."""
    b, n = x.shape
    c = torch.cumsum(x.reshape(-1), 0)
    start = torch.cat([c.new_zeros(1), c])[
        torch.arange(b, device=x.device) * n]
    return c.reshape(b, n) - start[:, None]


def scatter_front(dest: torch.Tensor, values: torch.Tensor, capacity: int,
                  fill=0) -> torch.Tensor:
    """Per lane b of (B, M, ...) `values`, write row m to row dest[b, m] of
    a (capacity, ...) buffer filled with `fill`; rows with dest >= capacity
    are dropped (into one spare row). Returns (B, capacity, ...),
    contiguous for every B. One index_put over all lanes."""
    b, m = dest.shape
    tail = values.shape[2:]
    lane = torch.arange(b, device=dest.device)[:, None] * capacity
    flat = torch.where(dest < capacity, lane + dest,
                       torch.full_like(dest, b * capacity)).reshape(-1)
    buf = torch.full((b * capacity + 1,) + tail, fill, dtype=values.dtype,
                     device=values.device)
    buf[flat] = values.reshape((b * m,) + tail)
    return buf[:b * capacity].reshape((b, capacity) + tail)


def _dest(sel: torch.Tensor, seg: torch.Tensor, capacity: int):
    return torch.where(sel & (seg < capacity), seg,
                       torch.full_like(seg, capacity)).to(torch.int64)


def _one_lane(fn):
    """Run a (B, ...) lanes function on one cloud: every tensor argument
    gains a leading lane dim of 1, every tensor result loses it."""
    def wrap(*args, **kw):
        lift = [a[None] if isinstance(a, torch.Tensor) else a for a in args]
        kw = {k: v[None] if isinstance(v, torch.Tensor) else v
              for k, v in kw.items()}
        out = fn(*lift, **kw)
        return tuple(o[0] if isinstance(o, torch.Tensor) else o for o in out)
    return wrap


def morton_sort_points(points: torch.Tensor, mask: torch.Tensor,
                       quant: float = 1.0):
    """A padded (P, 3) cloud sorted spatially by its morton key (stable;
    invalid rows last). Returns (points, mask) reordered."""
    key = _masked_key(_voxel_key_morton(points, mask, quant), mask)
    _, order = lane_sort(key[None])
    return points[order[0]], mask[order[0]]


def voxel_downsample_labeled(points: torch.Tensor, labels: torch.Tensor,
                             mask: torch.Tensor, leaf: float, capacity: int):
    """Centroid per voxel with the voxel's largest label (clouds already
    split by class, as the reference filters them). Returns (points (C, 3),
    labels (C,) int32, -1 in empty slots, mask (C,))."""
    h = _masked_key(_voxel_key(points, mask, leaf), mask)
    hs, order = lane_sort(h[None])
    hs, order = hs[0], order[0]
    ms = mask[order]
    is_new, _ = _run_starts(hs)
    seg = lane_cumsum(is_new[None].to(torch.int32))[0] - 1
    dest = torch.where(ms & (seg < capacity) & (seg >= 0), seg,
                       torch.full_like(seg, capacity))
    sums = torch.zeros((capacity + 1, 3), dtype=points.dtype,
                       device=points.device).index_add_(0, dest,
                                                        points[order])
    cnts = torch.zeros(capacity + 1, dtype=torch.int32,
                       device=points.device).index_add_(
        0, dest, torch.ones_like(dest, dtype=torch.int32))
    lab = torch.full((capacity + 1,), -1, dtype=torch.int32,
                     device=points.device).scatter_reduce_(
        0, dest, labels[order].to(torch.int32), "amax")
    out = sums[:capacity] / torch.clamp(cnts[:capacity, None], min=1)
    return out, lab[:capacity], cnts[:capacity] > 0


def _centroids(points: torch.Tensor, order: torch.Tensor,
               dest_first: torch.Tensor, dest_last: torch.Tensor,
               capacity: int) -> torch.Tensor:
    """Per-voxel mean of each lane's sorted runs, without atomics: a float64
    cumsum of the sorted points along each lane, differenced at each run's
    first and last row, then divided by the run's length and rounded to the
    points' dtype. A float scatter-add on CUDA adds in atomic order and
    would not repeat itself from run to run; this does."""
    b, n = order.shape
    # coordinates first, so the scan runs along the innermost dim: along
    # the middle dim of (B, P, 3), CUDA's scan is serial per column (8.4
    # of the call's 8.9 ms at P = 65536 on an H100)
    ps = torch.take_along_dim(points, order[..., None], dim=1).double()
    ps = ps.transpose(1, 2).contiguous()
    c = torch.cat([ps.new_zeros(b, 3, 1), torch.cumsum(ps, dim=-1)], dim=-1)
    pos = torch.arange(n, device=order.device).expand(b, n)
    first = scatter_front(dest_first, pos, capacity)[:, None]
    last = scatter_front(dest_last, pos, capacity)[:, None]
    s = (torch.take_along_dim(c, (last + 1).expand(b, 3, capacity), dim=-1)
         - torch.take_along_dim(c, first.expand(b, 3, capacity), dim=-1))
    cnt = (last + 1 - first).clamp(min=1)
    return (s / cnt.double()).transpose(1, 2).to(points.dtype)


def voxel_downsample(points: torch.Tensor, mask: torch.Tensor, leaf: float,
                     capacity: int, payloads: tuple = (),
                     centroid: bool = False):
    """One point per voxel. Returns (points (C,3), mask (C,), count[,
    payloads (C,) ...]). By default the point kept is the FIRST of its
    voxel in input order (stable sort on the key); each per-point float
    column of `payloads` comes out aligned with the kept points (0 in empty
    slots). With `centroid`, each voxel's mean instead (PCL VoxelGrid),
    voxels in ascending key order, deterministic on the card (see
    _centroids); `payloads` is refused there, as in JAX. Empty slots are 0
    and masked out; count is the number of voxels, capped at `capacity`.
    With a leading lane dim, (B, P, 3) points and (B, P) mask and
    payloads, every lane is downsampled on its own (count (B,))."""
    if centroid and payloads:
        raise ValueError("voxel_downsample: payloads are not supported with "
                         "centroid=True")
    if points.dim() == 2:
        return _one_lane(lambda p, m, *pl: voxel_downsample(
            p, m, leaf, capacity, pl, centroid))(points, mask, *payloads)
    h = _masked_key(_voxel_key(points, mask, leaf), mask)
    hs, order = lane_sort(h)
    is_new, is_last = _run_starts(hs)
    seg = lane_cumsum(is_new.to(torch.int32)) - 1
    k = torch.clamp(torch.sum(is_new.to(torch.int32), -1), max=capacity)
    out_mask = torch.arange(capacity, device=points.device) < k[:, None]
    if centroid:
        buf = _centroids(points, order, _dest(is_new, seg, capacity),
                         _dest(is_last, seg, capacity), capacity)
        buf = torch.where(out_mask[..., None], buf, torch.zeros_like(buf))
        return buf, out_mask, k
    cols = torch.cat([points] + [p.to(points.dtype)[..., None]
                                 for p in payloads], dim=-1)
    buf = scatter_front(_dest(is_new, seg, capacity),
                        torch.take_along_dim(cols, order[..., None], dim=1),
                        capacity)
    buf = torch.where(out_mask[..., None], buf, torch.zeros_like(buf))
    return (buf[..., :3], out_mask, k) + tuple(
        buf[..., 3 + i] for i in range(len(payloads)))


def voxel_merge_aged(new_points: torch.Tensor, new_mask: torch.Tensor,
                     map_points: torch.Tensor, map_age: torch.Tensor,
                     map_mask: torch.Tensor, kf_index, window: int,
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

    `kf_index` is an int or an int tensor on the clouds' device (no host
    sync). With a leading lane dim on every cloud ((B, P, 3) points, (B, P)
    masks, ages and flags) and kf_index (B,), each lane merges on its own.

    With `new_flag`/`map_flag`, a per-point bool rides the merge and
    follows its POINT (the anchored one), e.g. the dynamic-class flag of
    the semantic local map. Returns (points (C,3), age (C,), mask (C,)
    [, flag (C,)])."""
    if anchor not in ("first", "newest"):
        raise ValueError(f"anchor must be 'first'|'newest', got {anchor!r}")
    if new_points.dim() == 2:
        flags = () if new_flag is None else (new_flag, map_flag)
        return _one_lane(lambda np_, nm, mp, ma, mm, ki, *fl: voxel_merge_aged(
            np_, nm, mp, ma, mm, ki, window, leaf, capacity, anchor, *fl))(
            new_points, new_mask, map_points, map_age, map_mask, kf_index,
            *flags)
    dev = new_points.device
    shape = new_points.shape[:2]
    if isinstance(kf_index, torch.Tensor):
        kf_index = kf_index.reshape(-1, 1).to(torch.int32)
        new_age = kf_index.expand(shape)
    else:
        new_age = torch.full(shape, kf_index, dtype=torch.int32, device=dev)
    alive = map_mask & (map_age > kf_index - window)
    pts = torch.cat([new_points, map_points], dim=1)
    age = torch.cat([new_age, map_age], dim=1)
    mask = torch.cat([new_mask, alive], dim=1)
    h = _masked_key(_voxel_key_morton(pts, mask, leaf), mask)
    hs, order = lane_sort(h)
    is_first, is_last = _run_starts(hs)
    seg = lane_cumsum(is_first.to(torch.int32)) - 1
    is_anchor = is_last if anchor == "first" else is_first
    k = torch.clamp(torch.sum(is_first.to(torch.int32), -1), max=capacity)
    out_mask = torch.arange(capacity, device=dev) < k[:, None]
    anchor_dest = _dest(is_anchor, seg, capacity)
    out_pts = scatter_front(anchor_dest,
                            torch.take_along_dim(pts, order[..., None], 1),
                            capacity)
    out_pts = torch.where(out_mask[..., None], out_pts,
                          torch.zeros_like(out_pts))
    out_age = scatter_front(_dest(is_first, seg, capacity),
                            torch.take_along_dim(age, order, 1), capacity)
    out_age = torch.where(out_mask, out_age,
                          torch.full_like(out_age, -(10**9)))
    if new_flag is None:
        return out_pts, out_age, out_mask
    flag = torch.cat([new_flag, map_flag], dim=1)
    out_flag = scatter_front(anchor_dest, torch.take_along_dim(flag, order, 1),
                             capacity, fill=False)
    return out_pts, out_age, out_mask, out_flag & out_mask


def compact_masked(points: torch.Tensor, mask: torch.Tensor, capacity: int):
    """Pack masked rows of (N, 3) into a (capacity, 3) buffer (order kept).
    Returns (points, mask)."""
    pos = torch.cumsum(mask.to(torch.int32), 0) - 1
    buf = torch.zeros((capacity + 1, 3), dtype=points.dtype,
                      device=points.device)
    buf[_dest(mask, pos, capacity)] = points
    cnt = torch.clamp(torch.sum(mask.to(torch.int32)), max=capacity)
    return buf[:capacity], torch.arange(capacity, device=points.device) < cnt
