"""Range-image projection and per-ring compaction (port of
lis_slam_tpu/ops/projection.py; reference src/core/laserProcessing.cpp
projectPointCloud :467-510 + cloudExtraction :515-539).

`project_and_extract` is the production path, one sort for both steps: on
pixel collisions the NEAREST point (min quantized range, then lowest raw
index) wins, as in the JAX package. `project` + `extract` are the unfused
pair, the JAX package's reference, which the RangeNet training recipe
(train/recipe.py) projects its labelled scans with: there the nearest
exact range wins, and among equal ranges the highest raw index.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..config import SensorConfig
from .pretreatment import norm3, sum_sq3
from .voxel import lane_cumsum, lane_sort, scatter_front

_INVALID_RANGE = 1e9
_KEY_INVALID = 2**31 - 1


class RangeImage(NamedTuple):
    """Projected scan on the fixed (N_SCAN, H) grid."""

    rng: torch.Tensor  # (N, H) float32 range; _INVALID_RANGE where empty
    xyz: torch.Tensor  # (N, H, 3)
    intensity: torch.Tensor  # (N, H)
    time: torch.Tensor  # (N, H) per-point relative time
    mask: torch.Tensor  # (N, H) bool


class ExtractedCloud(NamedTuple):
    """Per-row compacted valid pixels (cloudExtraction equivalent)."""

    rng: torch.Tensor  # (N, H) compacted ranges, _INVALID_RANGE past count
    xyz: torch.Tensor  # (N, H, 3)
    intensity: torch.Tensor  # (N, H)
    col: torch.Tensor  # (N, H) original column index, -1 padded
    count: torch.Tensor  # (N,) valid count per row
    mask: torch.Tensor  # (N, H) bool, True for compacted slots < count
    src: torch.Tensor  # (N, H) raw-point index of each slot, -1 padded


def _f32(x: float) -> float:
    """`x` rounded to the nearest float32."""
    return torch.tensor(x, dtype=torch.float32).item()


_DEG = _f32(180.0 / math.pi)


def pixel_columns(points: torch.Tensor, h: int) -> torch.Tensor:
    """(..., P) int32 range-image column of each point (projectPointCloud's
    horizon angle); may fall outside [0, h) for degenerate points.

    Rounded as the JAX package's CPU program computes
    round((atan2(x, y) * 180 / pi - 90) / (360 / h)): XLA turns the
    division into a product with the float32 reciprocal and fuses the
    degree conversion and the - 90 into one multiply-add (emulated in
    float64, where the float32 product is exact). The plain expression
    puts a point lying on a half column into the other column (3 of a
    64 x 1800 scan's points)."""
    ang = torch.atan2(points[..., 0], points[..., 1])
    shifted = (ang.double() * _DEG - 90.0).float()
    col = -torch.round(shifted * _f32(1.0 / _f32(360.0 / h)))
    col = col.to(torch.int32) + h // 2
    return torch.where(col >= h, col - h, col)


def norm_fma(p: torch.Tensor) -> torch.Tensor:
    """Euclidean norm of the last axis of (..., 3) rounded as the JAX
    package's CPU program rounds jnp.linalg.norm: sum_sq3's fused
    multiply-adds, then a correctly rounded square root (float64, then
    float32; torch's float32 sqrt on the CPU is not always correctly
    rounded). norm3's plain sum differs in the last bit for ~7% of a
    scan's points."""
    return torch.sqrt(sum_sq3(p).double()).float()


def range_image(ext: ExtractedCloud,
                time: torch.Tensor | None = None) -> RangeImage:
    """The (N_SCAN, H) grid image of the compacted winners: each slot goes
    back to its pixel (row, col). `time` is the slots' relative time (N, H)
    (zeros without it; RangeNet does not read it). The range is norm_fma,
    so RangeNet's input matches the JAX package's bit for bit; the
    projection's sort key keeps norm3."""
    n, h = ext.mask.shape
    rows = torch.arange(n, device=ext.mask.device)[:, None].expand(n, h)
    dest = torch.where(ext.mask, rows * h + ext.col,
                       torch.full_like(ext.col, n * h)).reshape(-1).long()
    if time is None:
        time = torch.zeros_like(ext.intensity)
    payload = torch.cat([ext.xyz, ext.intensity[..., None], time[..., None]],
                        dim=-1).reshape(n * h, 5)
    grid = torch.zeros((n * h + 1, 5), dtype=torch.float32,
                       device=payload.device)
    grid[dest] = payload
    grid = grid[: n * h]
    hit = torch.zeros(n * h + 1, dtype=torch.bool, device=payload.device)
    hit.index_fill_(0, dest, True)  # no host value copied to the device
    hit = hit[: n * h]
    rng = norm_fma(grid[:, :3])
    return RangeImage(
        rng=torch.where(hit, rng, torch.full_like(rng, _INVALID_RANGE))
        .reshape(n, h),
        xyz=grid[:, :3].reshape(n, h, 3),
        intensity=grid[:, 3].reshape(n, h),
        time=grid[:, 4].reshape(n, h),
        mask=hit.reshape(n, h))


def _in_grid(points, ring, valid, rng, cfg: SensorConfig):
    """(ok, column) of each point: valid, in the range gate, on a kept
    ring and a column of the grid."""
    n, h = cfg.n_scan, cfg.horizon_scan
    ok = valid & (rng >= cfg.lidar_min_range) & (rng <= cfg.lidar_max_range)
    ok &= (ring >= 0) & (ring < n)
    if cfg.downsample_rate > 1:
        ok &= ring % cfg.downsample_rate == 0
    col = pixel_columns(points, h)
    return ok & (col >= 0) & (col < h), col


def project(points: torch.Tensor, intensity: torch.Tensor,
            ring: torch.Tensor, rel_time: torch.Tensor, valid: torch.Tensor,
            cfg: SensorConfig) -> RangeImage:
    """Scatter one scan's (P, 3) points into the (N_SCAN, H) range image,
    nearest range wins, in two passes as the JAX package's `project`:
    each pixel's minimum range (scatter_reduce "amin"), then the payload
    (xyz, intensity, rel_time) of its winner, one gather.

    The range is norm_fma, JAX's jnp.linalg.norm bit for bit; the image
    and its payload are exact (the recipe rounds labels back out of
    rel_time). Among winners of equal range the highest raw index wins:
    JAX writes them all with one colliding scatter-set and its CPU
    program keeps the last write, where a colliding write on CUDA keeps
    an arbitrary one; here an "amax" of the winners' raw indices picks
    each pixel's source first."""
    n, h = cfg.n_scan, cfg.horizon_scan
    dev = points.device
    rng = norm_fma(points)
    ok, col = _in_grid(points, ring, valid, rng, cfg)
    spill = torch.full_like(col, n * h, dtype=torch.int64)
    flat = torch.where(ok, ring * h + col, spill)
    rng = torch.where(ok, rng, torch.full_like(rng, _INVALID_RANGE))
    best = torch.full((n * h + 1,), _INVALID_RANGE, dtype=torch.float32,
                      device=dev).scatter_reduce_(0, flat, rng, "amin")
    winner = ok & (rng <= best[flat])
    src = torch.full((n * h + 1,), -1, dtype=torch.int64,
                     device=dev).scatter_reduce_(
        0, torch.where(winner, flat, spill),
        torch.arange(points.shape[0], device=dev), "amax")[: n * h]
    payload = torch.cat([points, intensity[:, None], rel_time[:, None]],
                        dim=1)
    img = torch.where((src >= 0)[:, None], payload[src.clamp(min=0)],
                      torch.zeros((), dtype=payload.dtype, device=dev))
    rng_img = best[: n * h].reshape(n, h)
    return RangeImage(rng=rng_img, xyz=img[:, :3].reshape(n, h, 3),
                      intensity=img[:, 3].reshape(n, h),
                      time=img[:, 4].reshape(n, h),
                      mask=rng_img < _INVALID_RANGE * 0.5)


def extract(img: RangeImage) -> ExtractedCloud:
    """Per-row stable compaction of an image's valid pixels
    (cloudExtraction): slot = the pixel's rank among its row's valid
    pixels, so column order holds; one scatter with unique destinations.
    Empty slots get range _INVALID_RANGE and column -1; `src` is all -1
    (the raw indices are not known here)."""
    n, h = img.rng.shape
    dev = img.rng.device
    valid = img.mask
    pos = torch.cumsum(valid.to(torch.int64), dim=1) - 1
    rows = torch.arange(n, device=dev)[:, None]
    cols = torch.arange(h, device=dev).expand(n, h)
    dest = torch.where(valid, rows * h + pos, torch.full_like(pos, n * h))
    payload = torch.cat([img.rng[..., None], img.xyz,
                         img.intensity[..., None],
                         cols[..., None].to(torch.float32)], dim=-1)
    buf = scatter_front(dest.reshape(1, -1), payload.reshape(1, n * h, 6),
                        n * h)[0].reshape(n, h, 6)
    count = valid.sum(dim=1, dtype=torch.int32)
    mask = torch.arange(h, device=dev) < count[:, None]
    none = torch.full((n, h), -1, dtype=torch.int32, device=dev)
    return ExtractedCloud(
        rng=torch.where(mask, buf[..., 0],
                        torch.full_like(buf[..., 0], _INVALID_RANGE)),
        xyz=buf[..., 1:4], intensity=buf[..., 4],
        col=torch.where(mask, buf[..., 5].to(torch.int32), none),
        count=count, mask=mask, src=none)


def project_and_extract(points: torch.Tensor, intensity: torch.Tensor,
                        ring: torch.Tensor, rel_time: torch.Tensor,
                        valid: torch.Tensor, cfg: SensorConfig,
                        want_image: bool = False):
    """Project onto the (N_SCAN, H) grid and compact each row's winners to
    its front, via ONE stable sort on a packed (pixel, quantized-range) key:
    the first entry per pixel is the nearest-range winner, and winners come
    out in row-major pixel order. Returns (RangeImage or None,
    ExtractedCloud): the grid image of the winners (`want_image=True`,
    what RangeNet reads; the front end skips it).

    Scans may carry a leading lane dim ((B, P, 3) points, (B, P) the
    rest): each lane is projected on its own, in the same launches, and the
    ExtractedCloud fields gain the lane dim (no image then)."""
    one = points.dim() == 2
    if one:
        points, intensity, ring, rel_time, valid = (
            t[None] for t in (points, intensity, ring, rel_time, valid))
    elif want_image:
        raise ValueError("project_and_extract: the image is for one scan")
    ext, time = _project_lanes(points, intensity, ring, rel_time, valid, cfg)
    if one:
        ext, time = ExtractedCloud(*(t[0] for t in ext)), time[0]
    return (range_image(ext, time) if want_image else None), ext


def _project_lanes(points, intensity, ring, rel_time, valid,
                   cfg: SensorConfig):
    """project_and_extract over (B, P) lanes: (ExtractedCloud with a lane
    dim, the compacted slots' relative time (B, N, H))."""
    n, h = cfg.n_scan, cfg.horizon_scan
    dev = points.device
    rng = norm3(points)
    ok, col = _in_grid(points, ring, valid, rng, cfg)

    pix = ring * h + col
    rq = torch.clamp(rng * (16383.0 / max(cfg.lidar_max_range, 1e-3)),
                     0, 16382).to(torch.int32)
    key = torch.where(ok, pix * 16384 + rq,
                      torch.full_like(pix, _KEY_INVALID))
    ks, order = lane_sort(key.to(torch.int64))
    ks = ks.to(torch.int32)
    # payload columns gathered in sorted order: rng, x, y, z, intensity,
    # time, src (raw index, exact in f32 for P < 2^24)
    src_f = order.to(torch.float32)
    xyz = torch.take_along_dim(points, order[..., None], dim=-2)
    wp = torch.stack([torch.take_along_dim(rng, order, -1), xyz[..., 0],
                      xyz[..., 1], xyz[..., 2],
                      torch.take_along_dim(intensity, order, -1),
                      torch.take_along_dim(rel_time, order, -1), src_f],
                     dim=-1)
    kpix = torch.div(ks, 16384, rounding_mode="floor")
    first = torch.cat([torch.ones_like(ks[:, :1], dtype=torch.bool),
                       kpix[:, 1:] != kpix[:, :-1]], dim=-1)
    first &= ks != _KEY_INVALID

    # winners are in row-major pixel order: a winner's slot in its row is
    # its global winner rank minus the row's first winner rank
    win_row = torch.where(first, torch.div(kpix, h, rounding_mode="floor"),
                          torch.full_like(kpix, n)).to(torch.int64)
    # non-winners add 0: counts stays a dense (B, n) buffer (a slice of a
    # spare-row buffer would make every lane-merging reshape of it copy
    # for B > 1 alone)
    row = torch.clamp(win_row, 0, n - 1)
    counts = torch.zeros((ks.shape[0], n), dtype=torch.int32,
                         device=dev).scatter_add_(1, row,
                                                  first.to(torch.int32))
    row_start = lane_cumsum(counts) - counts
    wrank = lane_cumsum(first.to(torch.int32)) - 1
    slot = wrank - torch.take_along_dim(row_start, row, -1)
    cdest = torch.where(first & (slot < h), win_row * h + slot,
                        torch.full_like(slot, n * h)).to(torch.int64)
    col_f = torch.remainder(kpix, h).to(torch.float32)
    payload = torch.cat([wp, col_f[..., None]], dim=-1)  # (B, P, 8)
    comp = scatter_front(cdest, payload, n * h).reshape(-1, n, h, 8)
    mask = torch.arange(h, device=dev) < counts[..., None]
    ext = ExtractedCloud(
        rng=torch.where(mask, comp[..., 0],
                        torch.full_like(comp[..., 0], _INVALID_RANGE)),
        xyz=comp[..., 1:4],
        intensity=comp[..., 4],
        col=torch.where(mask, comp[..., 7].to(torch.int32),
                        torch.full_like(mask, -1, dtype=torch.int32)),
        count=counts,
        mask=mask,
        src=torch.where(mask, comp[..., 6].to(torch.int32),
                        torch.full_like(mask, -1, dtype=torch.int32)),
    )
    return ext, comp[..., 5]
