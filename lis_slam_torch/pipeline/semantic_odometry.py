"""Back-end semantic refinement, stage 1 of the reference's back end (port
of lis_slam_tpu/pipeline/semantic_odometry.py; reference
subMapOptmizationNode.cpp keyframeInit :757-854, currentCloudInit
:856-893, scan2SubMapOptimization :1509-1541, icpAlignment :1435-1507).

Per keyframe: split the labeled scan into pole (corner) and dynamic +
ground + building (surf) clouds with per-point weights w = 2 -
LabelSorce[label], refine the front-end pose against a sliding semantic
local map by semantic-weighted LOAM Gauss-Newton (ICP fallback when the
solve is degenerate or unconverged), gate dynamic-class points by their
1-NN distance to the map's dynamic points (kernel K1, k=1), and merge the
clouds into the map. The JAX `lax.cond` of the fallback is a host branch.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import labels as L
from ..config import SlamConfig
from ..mapping import submap as sm
from ..ops import icp as icp_ops
from ..ops import knn, pretreatment, projection, scan_match, voxel
from ..utils import device as devices, se3

_POLE, _DYN, _GND, _BLD = (int(np.where(L.CATEGORY_IDS == c)[0][0]) for c in (
    L.CAT_POLE, L.CAT_DYNAMIC, L.CAT_GROUND, L.CAT_BUILDING))


class SemanticOdomState(NamedTuple):
    """Sliding semantic local map (localMap_t). The dynamic-class points
    live in the surf buffer with a flag, as in the JAX package."""

    pose: torch.Tensor  # (6,) refined pose
    kf_count: torch.Tensor  # () int32
    corner_pts: torch.Tensor  # (Mc, 3) pole-class map
    corner_age: torch.Tensor
    corner_mask: torch.Tensor
    surf_pts: torch.Tensor  # (Ms, 3) ground/building/dynamic map
    surf_w: torch.Tensor  # (Ms,) per-point semantic weight
    surf_age: torch.Tensor
    surf_mask: torch.Tensor
    surf_dyn: torch.Tensor  # (Ms,) dynamic-class flag


class SemanticScan(NamedTuple):
    """Per-keyframe semantic feature clouds (sensor frame)."""

    corner_xyz: torch.Tensor  # (Qc, 3) pole class
    corner_w: torch.Tensor  # (Qc,)
    corner_mask: torch.Tensor
    surf_xyz: torch.Tensor  # (Qs, 3) ground + building + dynamic
    surf_w: torch.Tensor
    surf_mask: torch.Tensor
    surf_is_dynamic: torch.Tensor  # (Qs,)
    class_xyz: torch.Tensor  # (5, Qk, 3), labels.CATEGORY_IDS order
    class_mask: torch.Tensor  # (5, Qk)
    class_w: torch.Tensor | None = None  # (5, Qk)


def init_state(cfg: SlamConfig, device: torch.device | str = "cuda"
               ) -> SemanticOdomState:
    device = devices.resolve(device)
    mc = cfg.submap.local_corner_capacity
    ms = cfg.submap.local_surf_capacity
    f32 = dict(dtype=torch.float32, device=device)
    never = dict(dtype=torch.int32, device=device)
    return SemanticOdomState(
        pose=torch.zeros(6, **f32),
        kf_count=torch.zeros((), **never),
        corner_pts=torch.zeros((mc, 3), **f32),
        corner_age=torch.full((mc,), -(10**9), **never),
        corner_mask=torch.zeros(mc, dtype=torch.bool, device=device),
        surf_pts=torch.zeros((ms, 3), **f32),
        surf_w=torch.ones(ms, **f32),
        surf_age=torch.full((ms,), -(10**9), **never),
        surf_mask=torch.zeros(ms, dtype=torch.bool, device=device),
        surf_dyn=torch.zeros(ms, dtype=torch.bool, device=device),
    )


def _compact(sel, xyz, w, extra, capacity: int):
    """Pack the selected grid points with their weight and extra column
    to the front of `capacity` slots (weight 1, extra 0 in the padding)."""
    flat = sel.reshape(-1)
    pos = torch.cumsum(flat.to(torch.int32), 0) - 1
    dest = torch.where(flat & (pos < capacity), pos,
                       torch.full_like(pos, capacity)).to(torch.int64)
    dev = xyz.device
    buf = torch.zeros((capacity + 1, 3), device=dev)
    buf[dest] = xyz.reshape(-1, 3)
    wbuf = torch.ones(capacity + 1, device=dev)
    wbuf[dest] = w.reshape(-1)
    ebuf = torch.zeros(capacity + 1, device=dev)
    ebuf[dest] = extra.reshape(-1)
    cnt = torch.clamp(torch.sum(flat.to(torch.int32)), max=capacity)
    return (buf[:capacity], wbuf[:capacity], ebuf[:capacity],
            torch.arange(capacity, device=dev) < cnt)


def _class_clouds(xyz, mask, cat, w, cfg: SlamConfig):
    """The 5 per-category keyframe clouds, each voxel-downsampled (pole at
    the corner leaf, the rest at the surf leaf), in ONE stable sort on
    (category, voxel key): the first point of each (class, voxel) run wins
    and lands at class * Qk + its rank in the class."""
    qk = cfg.submap.keyframe_class_capacity
    n_cat = len(L.CATEGORY_IDS)
    dev = xyz.device
    flat_cat = cat.reshape(-1)
    flat_mask = mask.reshape(-1) & (flat_cat >= 0)
    flat_xyz = xyz.reshape(-1, 3)
    vkey = torch.where(
        flat_cat == _POLE,
        voxel._voxel_key(flat_xyz, flat_mask, cfg.voxel.submap_corner_leaf),
        voxel._voxel_key(flat_xyz, flat_mask, cfg.voxel.submap_surf_leaf))
    ckey = torch.where(flat_mask, flat_cat, torch.full_like(flat_cat, n_cat))
    key = ckey.to(torch.int64) * (1 << 32) + vkey
    ks, order = torch.sort(key, stable=True)
    sc = torch.div(ks, 1 << 32, rounding_mode="floor")
    first = torch.ones_like(ks, dtype=torch.bool)
    first[1:] = ks[1:] != ks[:-1]
    win = first & (sc < n_cat)
    per_class = torch.stack([torch.sum((win & (sc == c)).to(torch.int32))
                             for c in range(n_cat)])
    counts = torch.clamp(per_class, max=qk)
    grank = torch.cumsum(win.to(torch.int32), 0) - 1
    start = torch.cumsum(per_class, 0) - per_class
    scc = torch.clamp(sc, 0, n_cat - 1)
    rank_in = grank - start[scc]
    dest = torch.where(win & (rank_in < qk), scc * qk + rank_in,
                       torch.full_like(scc, n_cat * qk))
    flat = torch.zeros((n_cat * qk + 1, 3), device=dev)
    flat[dest] = flat_xyz[order]
    wflat = torch.ones(n_cat * qk + 1, device=dev)
    wflat[dest] = w.reshape(-1)[order]
    class_mask = torch.arange(qk, device=dev)[None, :] < counts[:, None]
    return (flat[:n_cat * qk].reshape(n_cat, qk, 3), class_mask,
            wflat[:n_cat * qk].reshape(n_cat, qk))


def _semantic_scan_from_grids(xyz: torch.Tensor, mask: torch.Tensor,
                              lab_img: torch.Tensor,
                              cfg: SlamConfig) -> SemanticScan:
    """keyframeInit + currentCloudInit over (N, H) grids."""
    dev = xyz.device
    cat = torch.as_tensor(L.LEARNING_TO_CATEGORY, device=dev)[lab_img.long()]
    w = torch.as_tensor(L.RESIDUAL_WEIGHT, dtype=torch.float32,
                        device=dev)[lab_img.long()]
    cat = torch.where(mask, cat.to(torch.int32), torch.full_like(
        cat, -1, dtype=torch.int32))
    w = torch.where(mask, w, torch.ones_like(w))
    corner_sel = (cat == _POLE) & mask
    surf_sel = ((cat == _GND) | (cat == _BLD) | (cat == _DYN)) & mask
    dyn_sel = (cat == _DYN) & mask
    qc, qs = cfg.submap.corner_capacity // 8, cfg.feature.max_surf_points
    c_xyz, c_w, _, c_mask = _compact(corner_sel, xyz, w, w, qc)
    s_xyz, s_w, s_dyn, s_mask = _compact(surf_sel, xyz, w,
                                         dyn_sel.to(torch.float32), qs)
    # matched-cloud voxel downsample (keyframeInit's *DS clouds); weights
    # and the dynamic flag ride along
    c_xyz, c_mask, _nc, c_w = voxel.voxel_downsample(
        c_xyz, c_mask, cfg.voxel.submap_corner_leaf,
        cfg.submap.matched_corner_capacity, payloads=(c_w,))
    s_xyz, s_mask, _ns, s_w, s_dyn = voxel.voxel_downsample(
        s_xyz, s_mask, cfg.submap.refine_surf_leaf,
        cfg.submap.matched_surf_capacity, payloads=(s_w, s_dyn))
    class_xyz, class_mask, class_w = _class_clouds(xyz, mask, cat, w, cfg)
    return SemanticScan(
        corner_xyz=c_xyz, corner_w=c_w, corner_mask=c_mask,
        surf_xyz=s_xyz, surf_w=s_w, surf_mask=s_mask,
        surf_is_dynamic=s_dyn > 0.5, class_xyz=class_xyz,
        class_mask=class_mask, class_w=class_w)


def semantic_scan_from_ext(ext: projection.ExtractedCloud,
                           labels: torch.Tensor,
                           cfg: SlamConfig) -> SemanticScan:
    """The SemanticScan from the front end's extracted cloud: each grid
    slot carries its raw-point index (`src`), so its label is a gather."""
    src_ok = ext.src >= 0
    idx = torch.clamp(ext.src, 0, labels.shape[0] - 1).long()
    lab_img = torch.where(src_ok, labels[idx], torch.zeros_like(labels[idx]))
    return _semantic_scan_from_grids(ext.xyz, ext.mask & src_ok, lab_img,
                                     cfg)


def build_semantic_scan(scan, labels: torch.Tensor,
                        cfg: SlamConfig) -> SemanticScan:
    """keyframeInit + currentCloudInit from a raw scan (an
    odometry.ScanInput): pretreat, project, attach `labels` (per raw
    point learning-class ids) and split into the back end's feature sets.
    The fused SLAM step takes `semantic_scan_from_ext` on the front end's
    projection instead."""
    pre = pretreatment.pretreat(scan.points, scan.valid, cfg.sensor)
    _img, ext = projection.project_and_extract(
        pre.points[..., :3], pre.points[..., 3], pre.ring, pre.rel_time,
        pre.valid, cfg.sensor)
    return semantic_scan_from_ext(ext, labels, cfg)


def _icp_fallback(state: SemanticOdomState, sscan: SemanticScan,
                  pose: torch.Tensor) -> torch.Tensor:
    """icpAlignment / scan2SubMapOptimizationICP: point-to-plane ICP of the
    surf cloud against the local map; on fitness <= 3.0 (the reference's
    gate, :1482-1487) take yaw, x and y from it."""
    h = knn.build_hash(state.surf_pts, state.surf_mask, cell_size=1.0,
                       table_size=1 << 14)
    res = icp_ops.icp(sscan.surf_xyz, sscan.surf_mask, state.surf_pts, h,
                      se3.pose_to_matrix(pose), max_correspond_dist=1.0,
                      max_iterations=30, point_to_plane=True)
    p = se3.matrix_to_pose(res.transform).to(pose)
    if res.fitness <= 3.0 and bool(torch.all(torch.isfinite(p))):
        return torch.cat([pose[:2], p[2:5], pose[5:]])
    return pose


def refine_step(state: SemanticOdomState, sscan: SemanticScan,
                pose_guess: torch.Tensor, cfg: SlamConfig):
    """Semantic-weighted scan-to-local-map refinement + map update.
    Returns (state, refined pose (6,), GNState or None on the first
    keyframe, where the JAX package's solve runs but its result is not
    used)."""
    kf_count = int(state.kf_count)
    gn = None
    pose = pose_guess
    if kf_count > 0:
        gn = scan_match.scan_to_map(
            pose_guess, sscan.corner_xyz, sscan.corner_mask,
            sscan.surf_xyz, sscan.surf_mask,
            state.corner_pts, state.corner_mask,
            state.surf_pts, state.surf_mask,
            cfg.matching, cfg.matching.max_iterations_submap,
            corner_sem_weight=sscan.corner_w, surf_sem_weight=sscan.surf_w)
        pose = gn.pose
        if cfg.matching.icp_fallback and (gn.degenerate or not gn.converged):
            pose = _icp_fallback(state, sscan, pose)

    # --- update the semantic local map ---
    T = se3.pose_to_matrix(pose)
    c_w = se3.transform_points(T, sscan.corner_xyz)
    s_w = se3.transform_points(T, sscan.surf_xyz)
    sub = cfg.submap
    dyn_keep = sm.dynamic_removal_mask(
        s_w, sscan.surf_mask & sscan.surf_is_dynamic,
        state.surf_pts, state.surf_mask & state.surf_dyn, pose[3:],
        sub.dynamic_removal_radius, sub.dynamic_near, sub.dynamic_min,
        sub.dynamic_max)
    surf_insert = sscan.surf_mask & (~sscan.surf_is_dynamic | dyn_keep)
    K = cfg.keyframe.window_size
    corner_pts, corner_age, corner_mask = voxel.voxel_merge_aged(
        c_w, sscan.corner_mask, state.corner_pts, state.corner_age,
        state.corner_mask, kf_count, K, cfg.voxel.submap_corner_leaf,
        state.corner_pts.shape[0], anchor=cfg.voxel.map_anchor)
    surf_pts, surf_age, surf_mask, surf_dyn = voxel.voxel_merge_aged(
        s_w, surf_insert, state.surf_pts, state.surf_age, state.surf_mask,
        kf_count, K, cfg.voxel.submap_surf_leaf, state.surf_pts.shape[0],
        anchor=cfg.voxel.map_anchor,
        new_flag=sscan.surf_is_dynamic & dyn_keep, map_flag=state.surf_dyn)
    # map points keep weight 1: the reference weights only the current
    # scan's points
    new_state = SemanticOdomState(
        pose=pose, kf_count=state.kf_count + 1,
        corner_pts=corner_pts, corner_age=corner_age, corner_mask=corner_mask,
        surf_pts=surf_pts, surf_w=state.surf_w, surf_age=surf_age,
        surf_mask=surf_mask, surf_dyn=surf_dyn)
    return new_state, pose, gn
