"""LOAM feature extraction: curvature, occlusion masking, sector top-k
(port of lis_slam_tpu/ops/features.py, vectorized selection; reference
src/core/laserProcessing.cpp calculateSmoothness :544-563,
markOccludedPoints :568-605, extractFeatures :610-713).

The reference-faithful greedy pick-and-suppress selection
(`greedy=True` in the JAX package) is not ported yet and raises.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import FeatureConfig
from .projection import ExtractedCloud

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
    """Pack the rows of each (M, ...) tensor in `values` where `ok` (M,) is
    set to the front of a (capacity, ...) buffer, keeping order; empty
    slots take the matching fill. Returns (buffers..., mask)."""
    pos = torch.cumsum(ok.to(torch.int32), 0) - 1
    dest = torch.where(ok & (pos < capacity), pos,
                       torch.full_like(pos, capacity)).to(torch.int64)
    outs = []
    for v, fill in zip(values, fills):
        buf = torch.full((capacity + 1,) + v.shape[1:], fill, dtype=v.dtype,
                         device=v.device)
        buf[dest] = v
        outs.append(buf[:capacity])
    cnt = torch.clamp(torch.sum(ok.to(torch.int32)), max=capacity)
    return outs + [torch.arange(capacity, device=ok.device) < cnt]


def _gather_indexed(xyz, inten, idx, ok, capacity):
    """Compact (row, slot)-indexed selections into a fixed buffer.
    xyz (N,H,3); idx (N,S,K) slot indices; ok (N,S,K) validity."""
    h = xyz.shape[1]
    rows = torch.arange(idx.shape[0], device=idx.device)[:, None, None]
    flat = (rows * h + torch.clamp(idx, 0, h - 1)).reshape(-1)
    return _scatter_front(ok.reshape(-1),
                          (xyz.reshape(-1, 3)[flat], inten.reshape(-1)[flat]),
                          capacity, (0.0, 0.0))


def _gather_flagged(xyz, inten, flag, src, capacity):
    """Compact flagged (N,H) points into a fixed-capacity buffer, with the
    per-slot source index (-1 in padding slots)."""
    buf, ibuf, sbuf, mask = _scatter_front(
        flag.reshape(-1),
        (xyz.reshape(-1, 3), inten.reshape(-1), src.reshape(-1)),
        capacity, (0.0, 0.0, -1))
    return buf, ibuf, mask, torch.where(mask, sbuf, torch.full_like(sbuf, -1))


def extract_features(ext: ExtractedCloud, cfg: FeatureConfig,
                     greedy: bool = False) -> FeatureClouds:
    """Feature extraction over all rings with the vectorized local-extremum
    selection (the production default)."""
    if greedy:
        raise NotImplementedError(
            "greedy feature selection is not ported yet; use "
            "FeatureConfig(greedy_selection=False)")
    curv, picked, _valid = curvature_and_occlusion(ext, cfg)
    corner_sel, sharp_sel, surf_f, ssurf_sel = (
        _select_row_features_vectorized(curv, picked, ext.count, cfg))
    corner_xyz, corner_int, corner_mask = _gather_indexed(
        ext.xyz, ext.intensity, *corner_sel, cfg.max_corner_points)
    sharp_xyz, _si, sharp_mask = _gather_indexed(
        ext.xyz, ext.intensity, *sharp_sel, cfg.max_sharp_corner_points)
    ssurf_xyz, _ssi, ssurf_mask = _gather_indexed(
        ext.xyz, ext.intensity, *ssurf_sel, cfg.max_sharp_surf_points)
    surf_xyz, surf_int, surf_mask, surf_src = _gather_flagged(
        ext.xyz, ext.intensity, surf_f, ext.src, cfg.max_surf_points)
    return FeatureClouds(
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
