"""LOAM feature extraction: curvature, occlusion masking, sector top-k
(port of lis_slam_tpu/ops/features.py, vectorized selection; reference
src/core/laserProcessing.cpp calculateSmoothness :544-563,
markOccludedPoints :568-605, extractFeatures :610-713).

Two selections: the vectorized local-extremum one (the production default)
and, with `greedy=True`, the reference-faithful pick-and-suppress replica,
batched over rings and sequential over the 6 sectors x (20 corner + 40
surf) picks, with the JAX package's lowest-index argmax/argmin ties.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import FeatureConfig
from .projection import ExtractedCloud
from .voxel import lane_cumsum, scatter_front

_BIG = 1e18


class FeatureClouds(NamedTuple):
    """Padded per-scan feature buffers (cloud_info equivalents)."""

    corner_xyz: torch.Tensor  # (Ck, 3)
    corner_mask: torch.Tensor  # (Ck,)
    sharp_corner_xyz: torch.Tensor  # (Cs, 3)
    sharp_corner_mask: torch.Tensor
    surf_xyz: torch.Tensor  # (Sk, 3) — all non-corner valid points
    surf_mask: torch.Tensor
    sharp_surf_xyz: torch.Tensor  # (Ss, 3)
    sharp_surf_mask: torch.Tensor
    corner_intensity: torch.Tensor  # (Ck,)
    surf_intensity: torch.Tensor  # (Sk,)
    surf_src: torch.Tensor  # (Sk,) int32 raw-point index, -1 padded


def curvature_and_occlusion(ext: ExtractedCloud, cfg: FeatureConfig):
    """Per-row curvature + neighbor-picked init mask. Returns (curvature
    (N,H), picked (N,H) bool — excluded from selection, valid (N,H))."""
    r = ext.rng
    h = r.shape[1]
    # 11-tap curvature: sum_{j=-5..5} r[i+j] - 10 r[i], squared
    kernel = (1.0, 1.0, 1.0, 1.0, 1.0, -10.0, 1.0, 1.0, 1.0, 1.0, 1.0)
    rz = torch.where(ext.mask, r, torch.zeros_like(r))
    acc = torch.zeros_like(rz)
    for j, kv in enumerate(kernel):
        acc = acc + kv * torch.roll(rz, 5 - j, dims=1)
    curv = acc * acc

    slot = torch.arange(h, device=r.device)[None, :]
    valid = ext.mask & (slot >= 5) & (slot < ext.count[:, None] - 5)

    # occlusion: compare compacted neighbors i and i+1
    r_next = torch.roll(r, -1, dims=1)
    col_diff = torch.abs(torch.roll(ext.col, -1, dims=1) - ext.col)
    near_cols = col_diff < cfg.occlusion_col_diff
    occl_fwd = near_cols & (r - r_next > cfg.occlusion_range_diff)
    occl_bwd = near_cols & (r_next - r > cfg.occlusion_range_diff)
    # occl_fwd at i marks i-5..i ; occl_bwd at i marks i+1..i+6
    mark = torch.zeros_like(valid)
    for d in range(0, 6):
        mark = mark | torch.roll(occl_fwd, -d, dims=1)
    for d in range(1, 7):
        mark = mark | torch.roll(occl_bwd, d, dims=1)

    # parallel beam: both compacted neighbors differ by > 2% of range
    r_prev = torch.roll(r, 1, dims=1)
    parallel = ((torch.abs(r_prev - r) > cfg.parallel_beam_ratio * r)
                & (torch.abs(r_next - r) > cfg.parallel_beam_ratio * r))

    picked = ~valid | (mark & valid) | (parallel & valid)
    curv = torch.where(valid, curv, torch.zeros_like(curv))
    return curv, picked, valid


def _window_extreme(x: torch.Tensor, radius: int, mode: str) -> torch.Tensor:
    """Sliding-window max/min over axis 1 via shifted elementwise ops."""
    op = torch.maximum if mode == "max" else torch.minimum
    out = x
    for d in range(1, radius + 1):
        out = op(out, torch.roll(x, d, dims=1))
        out = op(out, torch.roll(x, -d, dims=1))
    return out


def _top_k_lowest_index(score: torch.Tensor, k: int):
    """lax.top_k over the last axis: the k largest, ties in LOWEST index
    first (torch.topk promises no tie order; a stable descending sort
    does)."""
    v, i = torch.sort(score, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def _select_row_features_vectorized(curv, picked, count, cfg: FeatureConfig):
    """A candidate survives if it is the curvature extremum of its +-5
    compacted neighborhood (the spacing the reference's greedy suppression
    produces); then per (ring, sector) the top-N by curvature are kept.
    Returns ((corner_idx, corner_ok), sharp corner pair, surf_flag,
    (sharp_surf_idx, sharp_surf_ok)); index arrays are (N, sectors, K)."""
    n, h = curv.shape
    dev = curv.device
    idx = torch.arange(h, device=dev)[None, :]
    ns = cfg.sectors_per_ring
    sector_len = torch.clamp(count[:, None] - 10, min=1)
    # floor division: slots before the margin give negative numerators
    sector = torch.clamp(
        torch.div((idx - 5) * ns, sector_len, rounding_mode="floor"),
        0, ns - 1)

    free = ~picked
    neg_big = torch.full_like(curv, -_BIG)
    c_local = free & (curv > cfg.edge_threshold) & (
        curv >= _window_extreme(torch.where(free, curv, neg_big), 5, "max"))
    s_local = free & (curv < cfg.surf_threshold) & (
        curv <= _window_extreme(torch.where(free, curv, -neg_big), 5, "min"))

    # one batched top-k over a (rows*sectors, H) layout
    onehot = sector[:, None, :] == torch.arange(ns, device=dev)[None, :, None]
    score_c = torch.where(c_local[:, None, :] & onehot, curv[:, None, :],
                          neg_big[:, None, :]).reshape(n * ns, h)
    top_v, top_i = _top_k_lowest_index(score_c, cfg.max_corners_per_sector)
    corner_ok = (top_v > -_BIG).reshape(n, ns, -1)
    corner_idx = top_i.reshape(n, ns, -1)

    score_s = torch.where(s_local[:, None, :] & onehot, -curv[:, None, :],
                          neg_big[:, None, :]).reshape(n * ns, h)
    stop_v, stop_i = _top_k_lowest_index(score_s,
                                         cfg.max_sharp_surfs_per_sector)
    ssurf_ok = (stop_v > -_BIG).reshape(n, ns, -1)
    ssurf_idx = stop_i.reshape(n, ns, -1)

    nsc = cfg.max_sharp_corners_per_sector
    in_any = (idx >= 5) & (idx <= count[:, None] - 6)
    # surf cloud = every in-sector point that is not an edge candidate
    surf_flag = in_any & ~c_local
    return ((corner_idx, corner_ok),
            (corner_idx[:, :, :nsc], corner_ok[:, :, :nsc]),
            surf_flag,
            (ssurf_idx, ssurf_ok))


def _scatter_front(ok: torch.Tensor, values, capacity: int, fills):
    """Per lane of `ok` (B, M), pack the rows of each (B, M, ...) tensor in
    `values` where `ok` is set to the front of a (B, capacity, ...) buffer,
    keeping order; empty slots take the matching fill. Returns
    (buffers..., mask (B, capacity))."""
    pos = lane_cumsum(ok.to(torch.int32)) - 1
    dest = torch.where(ok & (pos < capacity), pos,
                       torch.full_like(pos, capacity)).to(torch.int64)
    outs = [scatter_front(dest, v, capacity, fill)
            for v, fill in zip(values, fills)]
    cnt = torch.clamp(torch.sum(ok.to(torch.int32), -1), max=capacity)
    return outs + [torch.arange(capacity, device=ok.device) < cnt[:, None]]


def _gather_indexed(xyz, inten, idx, ok, capacity):
    """Compact (row, slot)-indexed selections into a fixed buffer per lane.
    xyz (B,N,H,3); idx (B,N,S,K) slot indices; ok (B,N,S,K) validity."""
    b, n, h = inten.shape
    rows = torch.arange(n, device=idx.device)[:, None, None]
    flat = (rows * h + torch.clamp(idx, 0, h - 1)).reshape(b, -1)
    return _scatter_front(
        ok.reshape(b, -1),
        (torch.take_along_dim(xyz.reshape(b, -1, 3), flat[..., None], 1),
         torch.take_along_dim(inten.reshape(b, -1), flat, 1)),
        capacity, (0.0, 0.0))


def _gather_flagged(xyz, inten, flag, src, capacity):
    """Compact flagged (B,N,H) points into a fixed-capacity buffer per
    lane, with the per-slot source index (-1 in padding slots)."""
    b = flag.shape[0]
    buf, ibuf, sbuf, mask = _scatter_front(
        flag.reshape(b, -1),
        (xyz.reshape(b, -1, 3), inten.reshape(b, -1), src.reshape(b, -1)),
        capacity, (0.0, 0.0, -1))
    return buf, ibuf, mask, torch.where(mask, sbuf, torch.full_like(sbuf, -1))


def _sector_bounds(count: torch.Tensor, n_sectors: int):
    """Start/end compacted indices per sector (reference sp/ep):
    sp = (s*(6-j) + e*j)/6 with s = 4 and e = count - 6, floor division."""
    s, e = 4, count - 6
    return [(torch.div(s * (n_sectors - j) + e * j, n_sectors,
                       rounding_mode="floor"),
             torch.div(s * (n_sectors - 1 - j) + e * (j + 1), n_sectors,
                       rounding_mode="floor") - 1)
            for j in range(n_sectors)]


def _suppress_neighbors(picked, col_gap, ind, col_diff_limit):
    """Mark the +-5 compacted neighbors of `ind` (N,) in `picked` (N, H) as
    picked, each direction stopping at the first column gap >
    col_diff_limit (the reference's extractFeatures inner loops).
    col_gap[:, i] = |col[i] - col[i-1]|."""
    n, h = picked.shape
    rows = torch.arange(n, device=ind.device)[:, None]
    off = torch.arange(1, 6, device=ind.device)[None, :]
    marks = torch.cat([picked, torch.zeros_like(picked[:, :1])], dim=1)
    # forward j = ind+l against j-1; backward k = ind-l against k+1
    for j, gap_at in ((ind[:, None] + off, ind[:, None] + off),
                      (ind[:, None] - off, ind[:, None] - off + 1)):
        inside = (j >= 0) & (j < h)
        gap = col_gap[rows, torch.clamp(gap_at, 0, h - 1)]
        alive = torch.cummin((inside & (gap <= col_diff_limit)).to(
            torch.int32), dim=1).values.bool()
        # dead steps write to the spare column h
        marks[rows, torch.where(alive, j, torch.full_like(j, h))] = True
    return marks[:, :h]


def _select_rows_greedy(curv, picked, col, count, cfg: FeatureConfig):
    """Greedy corner + surf selection over all rings at once (_extract_row
    of the JAX package, vmapped there). Returns the (N, H) flags (corner,
    sharp corner, surf cloud, sharp surf)."""
    n, h = curv.shape
    dev = curv.device
    rows = torch.arange(n, device=dev)
    idx = torch.arange(h, device=dev)[None, :]
    col_gap = torch.abs(col - torch.roll(col, 1, dims=1))
    corner = torch.zeros_like(picked)
    sharp_corner = torch.zeros_like(picked)
    sharp_surf = torch.zeros_like(picked)
    in_any = torch.zeros_like(picked)
    edge = curv > cfg.edge_threshold
    flat = curv < cfg.surf_threshold
    neg_big = torch.full_like(curv, -_BIG)

    def pick(score, picked):
        ind = torch.argmax(score, dim=1)  # first max, as jnp.argmax
        hit = score[rows, ind] > -_BIG
        new_picked = picked.clone()
        new_picked[rows, ind] = True
        new_picked = _suppress_neighbors(new_picked, col_gap, ind,
                                         cfg.occlusion_col_diff)
        return ind, hit, torch.where(hit[:, None], new_picked, picked)

    for sp, ep in _sector_bounds(count, cfg.sectors_per_ring):
        in_sector = (idx >= sp[:, None]) & (idx <= ep[:, None])
        in_any = in_any | in_sector
        # corners: descending curvature
        for k in range(cfg.max_corners_per_sector):
            score = torch.where(in_sector & ~picked & edge, curv, neg_big)
            ind, hit, picked = pick(score, picked)
            corner[rows, ind] |= hit
            if k < cfg.max_sharp_corners_per_sector:
                sharp_corner[rows, ind] |= hit
        # surfs: ascending curvature (argmin as argmax of the negation,
        # same first-index ties); the first picks are the sharp surfs
        for k in range(cfg.max_sharp_surfs_per_sector * 4):
            score = torch.where(in_sector & ~picked & flat, -curv, neg_big)
            ind, hit, picked = pick(score, picked)
            if k < cfg.max_sharp_surfs_per_sector:
                sharp_surf[rows, ind] |= hit
    return corner, sharp_corner, in_any & ~corner, sharp_surf


def extract_features(ext: ExtractedCloud, cfg: FeatureConfig,
                     greedy: bool = False) -> FeatureClouds:
    """Feature extraction over all rings: the vectorized local-extremum
    selection (the production default), or with `greedy` the reference's
    pick-and-suppress replica. `ext` may carry a leading lane dim ((B, N,
    H) fields): the lanes' rings are selected together as one (B*N, H)
    set of rows, and each lane is compacted into its own buffers."""
    one = ext.mask.dim() == 2
    if one:
        ext = ExtractedCloud(*(t[None] for t in ext))
    b, n, h = ext.mask.shape
    rows = ExtractedCloud(*(t.reshape((b * n,) + t.shape[2:]) for t in ext))
    curv, picked, _valid = curvature_and_occlusion(rows, cfg)
    if greedy:
        flags = _select_rows_greedy(curv, picked, rows.col, rows.count, cfg)
        corner_f, sharp_f, surf_f, ssurf_f = (f.reshape(b, n, h)
                                              for f in flags)
        corner_xyz, corner_int, corner_mask, _ = _gather_flagged(
            ext.xyz, ext.intensity, corner_f, ext.src, cfg.max_corner_points)
        sharp_xyz, _si, sharp_mask, _ = _gather_flagged(
            ext.xyz, ext.intensity, sharp_f, ext.src,
            cfg.max_sharp_corner_points)
        ssurf_xyz, _ssi, ssurf_mask, _ = _gather_flagged(
            ext.xyz, ext.intensity, ssurf_f, ext.src,
            cfg.max_sharp_surf_points)
    else:
        corner_sel, sharp_sel, surf_f, ssurf_sel = (
            _select_row_features_vectorized(curv, picked, rows.count, cfg))
        corner_sel, sharp_sel, ssurf_sel = (
            tuple(t.reshape((b, n) + t.shape[1:]) for t in sel)
            for sel in (corner_sel, sharp_sel, ssurf_sel))
        surf_f = surf_f.reshape(b, n, h)
        corner_xyz, corner_int, corner_mask = _gather_indexed(
            ext.xyz, ext.intensity, *corner_sel, cfg.max_corner_points)
        sharp_xyz, _si, sharp_mask = _gather_indexed(
            ext.xyz, ext.intensity, *sharp_sel, cfg.max_sharp_corner_points)
        ssurf_xyz, _ssi, ssurf_mask = _gather_indexed(
            ext.xyz, ext.intensity, *ssurf_sel, cfg.max_sharp_surf_points)
    surf_xyz, surf_int, surf_mask, surf_src = _gather_flagged(
        ext.xyz, ext.intensity, surf_f, ext.src, cfg.max_surf_points)
    fc = FeatureClouds(
        corner_xyz=corner_xyz,
        corner_mask=corner_mask,
        sharp_corner_xyz=sharp_xyz,
        sharp_corner_mask=sharp_mask,
        surf_xyz=surf_xyz,
        surf_mask=surf_mask,
        sharp_surf_xyz=ssurf_xyz,
        sharp_surf_mask=ssurf_mask,
        corner_intensity=corner_int,
        surf_intensity=surf_int,
        surf_src=surf_src,
    )
    return FeatureClouds(*(t[0] for t in fc)) if one else fc
