"""Keyframe / SubMap data model and the submap manager's algorithms (port
of lis_slam_tpu/mapping/submap.py; reference src/include/subMap.h:
keyframe_t :237-428, submap_t :435-664, SubMapManager :781-1265).

Clouds are fixed-capacity padded tensors with masks, on the device that
produced them; poses and bookkeeping are host numpy. The JAX module pads
the member count of a closing submap to a few bucket sizes only to bound
XLA compiles: the padded rows are masked and change nothing, so the port
merges exactly the members (tests/test_torch_submap.py shows both agree
bit for bit). The random and fixed-count downsample masks of the JAX
module are not on any path and are not ported.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np
import torch

from ..config import SubMapConfig
from ..ops import knn_cuda, voxel
from ..utils import se3


class ClassClouds(NamedTuple):
    """One padded cloud per super-category (dynamic/ground/building/pole/
    outlier), the semantic_info payload."""

    xyz: torch.Tensor  # (5, C, 3)
    mask: torch.Tensor  # (5, C)
    w: torch.Tensor | None = None  # (5, C) per-point residual weight


@dataclass
class Keyframe:
    """keyframe_t: host poses, device clouds (sensor frame). The clouds
    become None once `release_clouds` fires (cfg.submap.release_after_
    submaps): nothing reads them after their submap closed and the loop
    verification window passed."""

    index: int
    pose_init: np.ndarray  # (4, 4) odometry pose
    pose_opt: np.ndarray  # (4, 4) optimized pose
    clouds: ClassClouds | None
    corner_xyz: torch.Tensor | None
    corner_mask: torch.Tensor | None
    surf_xyz: torch.Tensor | None
    surf_mask: torch.Tensor | None
    submap_id: int = -1
    timestamp: float = 0.0

    @property
    def released(self) -> bool:
        return self.surf_xyz is None

    def release_clouds(self) -> None:
        """Free the device clouds; poses, timestamp and ids stay."""
        self.clouds = None
        self.corner_xyz = self.corner_mask = None
        self.surf_xyz = self.surf_mask = None


@dataclass
class SubMap:
    """submap_t: merged world-frame clouds and bookkeeping."""

    index: int
    pose_init: np.ndarray  # (4, 4) pose of the first member keyframe
    pose_opt: np.ndarray
    corner_xyz: torch.Tensor
    corner_mask: torch.Tensor
    surf_xyz: torch.Tensor
    surf_mask: torch.Tensor
    kf_indices: list = field(default_factory=list)
    kf_rel_poses: list = field(default_factory=list)  # T_submap^-1 @ T_kf
    bbox: np.ndarray | None = None  # (2, 3) min/max on the host
    # the bbox as computed at close time, on the device; the SLAM drain
    # reads it back with the rest of its window
    bbox_dev: torch.Tensor | None = None
    class_xyz: torch.Tensor | None = None  # (5, C, 3), world frame
    class_mask: torch.Tensor | None = None  # (5, C)
    class_w: torch.Tensor | None = None  # (5, C) per-point residual weight

    def get_bbox(self) -> np.ndarray | None:
        """Host bbox; reads bbox_dev back on first use if the drain has
        not installed it yet."""
        if self.bbox is None and self.bbox_dev is not None:
            self.install_bbox(self.bbox_dev.cpu().numpy())
        return self.bbox

    def install_bbox(self, b: np.ndarray):
        self.bbox = b if np.all(np.isfinite(b)) else None
        self.bbox_dev = None

    def recompute_bbox(self) -> np.ndarray | None:
        """The host bbox from the surf cloud now (a restored submap);
        unchanged when the cloud is empty."""
        self.bbox_dev = None
        pts = self.surf_xyz.cpu().numpy()[self.surf_mask.cpu().numpy()]
        if len(pts):
            self.bbox = np.stack([pts.min(0), pts.max(0)])
        return self.bbox


def masked_bbox(pts: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(2, 3) min/max of the masked points; +-inf rows when empty."""
    inf = torch.full_like(pts, float("inf"))
    return torch.stack([
        torch.amin(torch.where(mask[:, None], pts, inf), dim=0),
        torch.amax(torch.where(mask[:, None], pts, -inf), dim=0)])


def judge_new_submap(accu_tran: float, accu_rot: float, accu_frame: int,
                     cfg: SubMapConfig) -> bool:
    """Cut criterion (subMap.h:1103-1122); accu_rot in radians."""
    return (accu_tran > cfg.translation_max or accu_rot > cfg.yaw_max
            or accu_frame > cfg.frames_size)


def bbox_mask(points: torch.Tensor, mask: torch.Tensor, bb_min, bb_max,
              delete_box: bool = False) -> torch.Tensor:
    """Axis-aligned box filter (bbx_filter): True = keep."""
    inside = torch.all((points > bb_min) & (points < bb_max), dim=-1)
    return mask & (~inside if delete_box else inside)


def dynamic_removal_mask(feature_pts: torch.Tensor, feature_mask: torch.Tensor,
                         map_pts: torch.Tensor, map_mask: torch.Tensor,
                         center: torch.Tensor, center_radius: float,
                         near_thre: float, min_thre: float,
                         max_thre: float) -> torch.Tensor:
    """map_scan_feature_pts_distance_removal (subMap.h:1065-1100): keep a
    candidate dynamic-class point iff its 1-NN distance to the dynamic map
    is in (near, min) U (max, inf); points beyond center_radius (in x-y)
    are always kept. The 1-NN is kernel K1 at k=1 on CUDA tensors (its
    plain version on CPU ones); an empty map gives +inf, the new-structure
    branch, as the KD-tree's far distance does."""
    d2c = torch.sum((feature_pts[:, :2] - center[None, :2]) ** 2, dim=-1)
    outside = d2c > center_radius * center_radius
    d, _i, _n = knn_cuda.knn(feature_pts.contiguous(), map_pts.contiguous(),
                             map_mask.contiguous(), k=1)
    d1 = d[:, 0]
    keep = (((d1 > near_thre ** 2) & (d1 < min_thre ** 2))
            | (d1 > max_thre ** 2))
    return feature_mask & (outside | keep)


def _merge_stacked(poses, xyz, mask, leaf: float, capacity: int):
    """(K,4,4), (K,P,3), (K,P) -> world-frame voxel-unique (capacity,3) +
    mask."""
    world = se3.transform_points(poses, xyz)
    out, om, _ = voxel.voxel_downsample(world.reshape(-1, 3),
                                        mask.reshape(-1), leaf, capacity)
    return out, om


def _merge_stacked_classes(poses, xyz, mask, w, leaf: float, capacity: int):
    """(K,5,Q,3), (K,5,Q), (K,5,Q) -> per-class world-frame voxel-unique
    (5,C,3) + mask + per-point weights riding the downsample."""
    world = se3.transform_points(poses[:, None], xyz)  # (K, 5, Q, 3)
    n_cls = xyz.shape[1]
    outs = [voxel.voxel_downsample(
        world[:, c].reshape(-1, 3), mask[:, c].reshape(-1), leaf, capacity,
        payloads=(w[:, c].reshape(-1),)) for c in range(n_cls)]
    return (torch.stack([o[0] for o in outs]),
            torch.stack([o[1] for o in outs]),
            torch.stack([o[3] for o in outs]))


class SubMapCollector:
    """Host-side grouping of keyframes into submaps (makeSubMapThread,
    subMapOptmizationNode.cpp:672-718 + saveSubMap :1134-1143)."""

    def __init__(self, cfg: SubMapConfig):
        self.cfg = cfg
        self.submaps: list[SubMap] = []
        self.accu_tran = 0.0
        self.accu_rot = 0.0
        self.accu_frame = 0
        self._cur_kfs: list[Keyframe] = []
        self._last_pose: np.ndarray | None = None
        # merge the per-category clouds on close (set by the pipeline when
        # labels flow; the keyframe class clouds are zeros otherwise)
        self.merge_classes = False

    def add_keyframe(self, kf: Keyframe) -> SubMap | None:
        """Returns the finished SubMap when the cut criterion fires."""
        if self._last_pose is not None:
            rel = np.linalg.inv(self._last_pose) @ kf.pose_init
            self.accu_tran += float(np.linalg.norm(rel[:3, 3]))
            self.accu_rot += abs(float(np.arctan2(rel[1, 0], rel[0, 0])))
        self._last_pose = kf.pose_init.copy()
        self._cur_kfs.append(kf)
        self.accu_frame += 1
        if judge_new_submap(self.accu_tran, self.accu_rot, self.accu_frame,
                            self.cfg):
            self.accu_tran = self.accu_rot = 0.0
            self.accu_frame = 0
            return self._finish()
        return None

    def flush(self) -> SubMap | None:
        """finishMap: close the trailing submap."""
        return self._finish() if self._cur_kfs else None

    def _finish(self) -> SubMap:
        kfs = self._cur_kfs
        self._cur_kfs = []
        base = kfs[0].pose_init
        base_inv = np.linalg.inv(base)
        dev = kfs[0].surf_xyz.device
        poses = torch.as_tensor(np.stack([kf.pose_init for kf in kfs]),
                                dtype=torch.float32, device=dev)

        def stack(get):
            return torch.stack([get(kf) for kf in kfs])

        # submap voxel leaves (params.yaml subMapCornerLeafSize /
        # subMapSurfLeafSize)
        corner, corner_m = _merge_stacked(
            poses, stack(lambda kf: kf.corner_xyz),
            stack(lambda kf: kf.corner_mask), 0.2, self.cfg.corner_capacity)
        surf, surf_m = _merge_stacked(
            poses, stack(lambda kf: kf.surf_xyz),
            stack(lambda kf: kf.surf_mask), 0.4, self.cfg.surf_capacity)
        class_xyz = class_mask = class_w = None
        if self.merge_classes:
            wshape = kfs[0].clouds.xyz.shape[:-1]
            kw = stack(lambda kf: kf.clouds.w if kf.clouds.w is not None
                       else torch.ones(wshape, device=dev))
            class_xyz, class_mask, class_w = _merge_stacked_classes(
                poses, stack(lambda kf: kf.clouds.xyz),
                stack(lambda kf: kf.clouds.mask), kw, 0.4,
                self.cfg.class_capacity)
        sm = SubMap(
            index=len(self.submaps), pose_init=base, pose_opt=base.copy(),
            corner_xyz=corner, corner_mask=corner_m,
            surf_xyz=surf, surf_mask=surf_m,
            kf_indices=[kf.index for kf in kfs],
            kf_rel_poses=[base_inv @ kf.pose_init for kf in kfs],
            class_xyz=class_xyz, class_mask=class_mask, class_w=class_w)
        for kf in kfs:
            kf.submap_id = sm.index
        sm.bbox_dev = masked_bbox(sm.surf_xyz, sm.surf_mask)
        self.submaps.append(sm)
        return sm
