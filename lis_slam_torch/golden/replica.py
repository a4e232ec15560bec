"""Plain-numpy CPU replica of the reference front-end odometry math.

This is the golden validation harness SURVEY.md §7 (hard part 4) calls for:
a faithful, ROS-free reimplementation of the EXACT math of the reference's
LiDAR-only front end, used to generate golden trajectories that the TPU
pipeline must track within 1% ATE (the stand-in for the KITTI-00/05 vs C++
north star while this environment has no KITTI data).

Faithful to, with file:line into /root/reference:
 - projection + extraction: `src/core/laserProcessing.cpp:467-539`
   (first-point-wins rangeMat fill, row-major compaction,
   startRingIndex = count-1+5 / endRingIndex = count-1-5),
 - smoothness / occlusion / greedy feature selection:
   `laserProcessing.cpp:544-713` — including the reference's quirks:
   the per-sector sort excludes index `ep` (`std::sort(begin+sp, begin+ep)`)
   while the pick loop includes it, and the surface cloud is indexed by
   position k, not smoothness[k].ind,
 - per-scan odometry: `src/node/odomEstimationNode.cpp`
   - updateInitialGuess constant-velocity branch (:352-392),
   - currentCloudInit: matched clouds = voxel-DS of the FULL corner/surf
     clouds (:260-281) with PCL centroid semantics,
   - multi-frame target map: merge last <20 world-frame keyframe clouds +
     voxel DS (:185-207, :452-467),
   - cornerOptimization (:633-747), surfOptimization (:749-827),
   - LMOptimization with the LOAM "camera convention" axis permutation and
     its approximate Jacobian (:829-974), degeneracy projection computed at
     iterCount==0 only, cv-ordering eigen checks,
   - keyframe gate: converged AND (id<=5 or |dyaw|>=miniYaw or
     |dx|>=miniDist or |dy|>=miniDist) (:216-228),
   - transformUpdate clamps (:976-1006).

Everything is float64 numpy (the reference is float32 OpenCV/Eigen; the
difference is far below the 1%-ATE comparison bound this harness serves).
"""

from __future__ import annotations

import numpy as np
from scipy.spatial import cKDTree

from ..config import SlamConfig


# ---------------------------------------------------------------------------
# geometry helpers (pcl::getTransformation convention: R = Rz(yaw)Ry(p)Rx(r))
# ---------------------------------------------------------------------------

# (shared with the production host path: utils/se3_np.py)
from ..utils.se3_np import matrix_to_pose, pose_to_matrix, transform_points  # noqa: E402,F401


# ---------------------------------------------------------------------------
# PCL VoxelGrid replica: per-voxel centroid, output ordered by voxel index
# ---------------------------------------------------------------------------

def pcl_voxel_downsample(pts: np.ndarray, leaf: float) -> np.ndarray:
    if len(pts) == 0:
        return pts
    mn = pts.min(axis=0)
    ijk = np.floor((pts - mn) / leaf).astype(np.int64)
    dims = ijk.max(axis=0) + 1
    key = (ijk[:, 2] * dims[1] + ijk[:, 1]) * dims[0] + ijk[:, 0]
    order = np.argsort(key, kind="stable")
    ks = key[order]
    ps = pts[order]
    new = np.concatenate([[True], ks[1:] != ks[:-1]])
    seg = np.cumsum(new) - 1
    n_vox = seg[-1] + 1
    sums = np.zeros((n_vox, 3))
    np.add.at(sums, seg, ps)
    cnts = np.bincount(seg, minlength=n_vox)
    return sums / cnts[:, None]


# ---------------------------------------------------------------------------
# front-end: projection + extraction + greedy features
# ---------------------------------------------------------------------------

def compute_ring(points: np.ndarray, valid: np.ndarray, n_scan: int):
    """Reference ring formula (laserPretreatment.cpp:33-60), numpy."""
    x, y, z = points[:, 0], points[:, 1], points[:, 2]
    horiz = np.sqrt(x * x + y * y)
    angle = np.degrees(np.arctan2(z, np.maximum(horiz, 1e-12)))
    if n_scan == 16:
        ring = np.floor((angle + 15.0) / 2.0 + 0.5).astype(np.int32)
        ok = (ring >= 0) & (ring <= n_scan - 1)
    elif n_scan == 64:
        upper = np.floor((2.0 - angle) * 3.0 + 0.5).astype(np.int32)
        lower = n_scan // 2 + np.floor((-8.83 - angle) * 2.0 + 0.5).astype(np.int32)
        ring = np.where(angle >= -8.83, upper, lower)
        ok = (angle <= 2.0) & (angle >= -24.33) & (ring >= 0) & (ring <= 50)
    else:
        raise ValueError(f"replica supports N_SCAN in (16, 64), got {n_scan}")
    return np.where(valid, ring, -1), valid & ok


class Extracted:
    """cloudExtraction output (laserProcessing.cpp:515-539)."""

    def __init__(self, xyz, rng, col, start_ring, end_ring):
        self.xyz = xyz  # (M, 3) compacted points, row-major pixel order
        self.rng = rng  # (M,)
        self.col = col  # (M,) original column index
        self.start_ring = start_ring  # (N,) startRingIndex
        self.end_ring = end_ring  # (N,) endRingIndex


def project_and_extract(points: np.ndarray, valid: np.ndarray,
                        cfg: SlamConfig) -> Extracted:
    """projectPointCloud + cloudExtraction, first-point-wins (:467-539)."""
    n, h = cfg.sensor.n_scan, cfg.sensor.horizon_scan
    pts = points[valid, :3]
    ring, ok = compute_ring(points[valid], np.ones(valid.sum(), bool),
                            cfg.sensor.n_scan)
    rng = np.linalg.norm(pts, axis=1)
    ok &= (rng >= cfg.sensor.lidar_min_range) & (rng <= cfg.sensor.lidar_max_range)
    ok &= ring % cfg.sensor.downsample_rate == 0
    ang_res = 360.0 / h
    horizon_angle = np.degrees(np.arctan2(pts[:, 0], pts[:, 1]))
    col = (-np.round((horizon_angle - 90.0) / ang_res)).astype(np.int64) + h // 2
    col = np.where(col >= h, col - h, col)
    ok &= (col >= 0) & (col < h)

    # first-point-wins per pixel (the sequential rangeMat fill :500):
    # np.unique returns the SMALLEST original index per unique key, and the
    # sorted unique keys are exactly row-major extraction order (:515-539)
    pix = (ring.astype(np.int64) * h + col)[ok]
    src = np.nonzero(ok)[0]
    uniq, first_idx = np.unique(pix, return_index=True)
    winners = src[first_idx]

    win_row = uniq // h
    counts = np.bincount(win_row, minlength=n)
    ends = np.cumsum(counts)
    start_ring = ends - counts - 1 + 5
    end_ring = ends - 1 - 5
    return Extracted(
        xyz=pts[winners],
        rng=rng[winners],
        col=(uniq % h),
        start_ring=start_ring,
        end_ring=end_ring,
    )


def extract_features(ext: Extracted, cfg: SlamConfig):
    """calculateSmoothness + markOccludedPoints + extractFeatures
    (laserProcessing.cpp:544-713), greedy and quirk-faithful.
    Returns (corner_cloud, surface_cloud) in sensor frame."""
    m = len(ext.rng)
    curv = np.zeros(m)
    picked = np.zeros(m, np.int8)
    label = np.zeros(m, np.int8)
    r = ext.rng
    # calculateSmoothness (:544-563), vectorized 11-tap difference
    if m > 10:
        d = -10.0 * r[5:m - 5]
        for off in (-5, -4, -3, -2, -1, 1, 2, 3, 4, 5):
            d = d + r[5 + off:m - 5 + off]
        curv[5:m - 5] = d * d

    # markOccludedPoints (:568-605): conditions only read rng/col, so the
    # flag computation vectorizes; the +-window marking loops over hits only
    i_ = np.arange(5, max(m - 6, 5))
    near_cols = np.abs(ext.col[i_ + 1] - ext.col[i_]) < 10
    occl_f = np.nonzero(near_cols & (r[i_] - r[i_ + 1] > 0.3))[0] + 5
    occl_b = np.nonzero(near_cols & (r[i_ + 1] - r[i_] > 0.3))[0] + 5
    for i in occl_f:
        picked[i - 5:i + 1] = 1
    for i in occl_b:
        picked[i + 1:i + 7] = 1
    diff1 = np.abs(r[i_ - 1] - r[i_])
    diff2 = np.abs(r[i_ + 1] - r[i_])
    picked[i_[(diff1 > 0.02 * r[i_]) & (diff2 > 0.02 * r[i_])]] = 1

    edge_thr = cfg.feature.edge_threshold
    surf_thr = cfg.feature.surf_threshold
    corner_idx: list[int] = []
    surf_idx: list[int] = []
    sm_ind = np.arange(m)  # cloudSmoothness[].ind, permuted by sector sorts

    def mark_neighbors(ind):
        picked[ind] = 1
        for l in range(1, 6):
            if ind + l >= m:
                break
            if abs(int(ext.col[ind + l]) - int(ext.col[ind + l - 1])) > 10:
                break
            picked[ind + l] = 1
        for l in range(-1, -6, -1):
            if ind + l < 0:
                break
            if abs(int(ext.col[ind + l]) - int(ext.col[ind + l + 1])) > 10:
                break
            picked[ind + l] = 1

    n = cfg.sensor.n_scan
    for i in range(n):
        for j in range(6):
            sp = (ext.start_ring[i] * (6 - j) + ext.end_ring[i] * j) // 6
            ep = (ext.start_ring[i] * (5 - j) + ext.end_ring[i] * (j + 1)) // 6 - 1
            if sp >= ep:
                continue
            # std::sort(begin+sp, begin+ep): index ep itself stays unsorted
            seg = sm_ind[sp:ep]
            seg = seg[np.argsort(curv[seg], kind="stable")]
            sm_ind[sp:ep] = seg

            n_pick = 0
            for k in range(ep, sp - 1, -1):
                ind = sm_ind[k]
                if picked[ind] == 0 and curv[ind] > edge_thr:
                    n_pick += 1
                    if n_pick <= 20:
                        label[ind] = 1
                        corner_idx.append(ind)
                    else:
                        break
                    mark_neighbors(ind)
            n_pick = 0
            for k in range(sp, ep + 1):
                ind = sm_ind[k]
                if picked[ind] == 0 and curv[ind] < surf_thr:
                    n_pick += 1
                    label[ind] = -1
                    mark_neighbors(ind)
            for k in range(sp, ep + 1):
                if label[k] <= 0:  # indexed by k, reference quirk
                    surf_idx.append(k)
    return ext.xyz[np.asarray(corner_idx, np.int64)], \
        ext.xyz[np.asarray(surf_idx, np.int64)]


# ---------------------------------------------------------------------------
# solver: cornerOptimization / surfOptimization / LMOptimization
# ---------------------------------------------------------------------------

def _corner_coeffs(pts_sel, tree: cKDTree, map_pts, cfg, weights=None):
    """(:633-747). Returns (ori_idx, coeff (k,3), res (k,)).

    `weights`: optional per-point semantic weights w = 2 - LabelSorce
    multiplied into coeff and residual (the back-end's semantic-weighted
    variant, subMapOptmizationNode.cpp:1671-1676)."""
    d, idx = tree.query(pts_sel, k=5)
    out_i, out_c, out_r = [], [], []
    for i in range(len(pts_sel)):
        if d[i, 4] ** 2 >= 1.0:
            continue
        near = map_pts[idx[i]]
        c = near.mean(axis=0)
        a = near - c
        cov = a.T @ a / 5.0
        evals, evecs = np.linalg.eigh(cov)  # ascending
        if evals[2] <= 3 * evals[1]:
            continue
        u = evecs[:, 2]
        x0 = pts_sel[i]
        x1, x2 = c + 0.1 * u, c - 0.1 * u
        cr = np.cross(x0 - x1, x0 - x2)
        a012 = np.linalg.norm(cr)
        l12 = np.linalg.norm(x1 - x2)
        if a012 < 1e-12:
            continue
        # la/lb/lc as written in the reference (:714-727)
        la = ((x1[1] - x2[1]) * cr[2] + (x1[2] - x2[2]) * cr[1]) / a012 / l12
        lb = -((x1[0] - x2[0]) * cr[2] - (x1[2] - x2[2]) * cr[0]) / a012 / l12
        lc = -((x1[0] - x2[0]) * cr[1] + (x1[1] - x2[1]) * cr[0]) / a012 / l12
        ld2 = a012 / l12
        s = 1 - 0.9 * abs(ld2)
        if s > 0.1:
            w = 1.0 if weights is None else float(weights[i])
            out_i.append(i)
            out_c.append(w * s * np.array([la, lb, lc]))
            out_r.append(w * s * ld2)
    return out_i, out_c, out_r


def _surf_coeffs(pts_sel, tree: cKDTree, map_pts, cfg, weights=None):
    """(:749-827); `weights` as in _corner_coeffs (:1795-1800)."""
    d, idx = tree.query(pts_sel, k=5)
    out_i, out_c, out_r = [], [], []
    for i in range(len(pts_sel)):
        if d[i, 4] ** 2 >= 1.0:
            continue
        near = map_pts[idx[i]]
        try:
            abc, *_ = np.linalg.lstsq(near, -np.ones(5), rcond=None)
        except np.linalg.LinAlgError:
            continue
        ps = np.linalg.norm(abc)
        if ps < 1e-12:
            continue
        nvec = abc / ps
        dd = 1.0 / ps
        if np.any(np.abs(near @ nvec + dd) > 0.2):
            continue
        pd2 = pts_sel[i] @ nvec + dd
        s = 1 - 0.9 * abs(pd2) / np.sqrt(np.linalg.norm(pts_sel[i]))
        if s > 0.1:
            w = 1.0 if weights is None else float(weights[i])
            out_i.append(i)
            out_c.append(w * s * nvec)
            out_r.append(w * s * pd2)
    return out_i, out_c, out_r


# ---------------------------------------------------------------------------
# back-end replicas: semantic-weighted scan-to-submap refinement
# (scan2SubMapOptimization, subMapOptmizationNode.cpp:1509-1967) and
# submap-to-submap registration (subMap2SubMapOptimization, :4485-4540)
# ---------------------------------------------------------------------------

def scan_to_submap_semantic(pose0, corner_pts, corner_w, surf_pts, surf_w,
                            map_corner, map_surf, cfg, max_iter=20):
    """Reference back-end stage-1 solve: the SAME corner/surf/LM math as the
    front end, with per-point semantic weights w = 2 - LabelSorce[label]
    multiplied into coefficients and residuals (:1671-1676, 1795-1800);
    <= 20 iterations (:1520). Points in sensor frame, map in world frame.
    Returns the optimized pose6."""
    pose = np.asarray(pose0, np.float64).copy()
    tree_c = cKDTree(map_corner) if len(map_corner) >= 5 else None
    tree_s = cKDTree(map_surf) if len(map_surf) >= 5 else None
    lm_state = {"matP": np.eye(6), "degenerate": False,
                "deltaR": 1e9, "deltaT": 1e9}
    for it in range(max_iter):
        T = pose_to_matrix(pose)
        ori, coef, res = [], [], []
        if tree_c is not None and len(corner_pts):
            sel = transform_points(T, corner_pts)
            i_, c_, r_ = _corner_coeffs(sel, tree_c, map_corner, cfg,
                                        weights=corner_w)
            ori += [corner_pts[j] for j in i_]
            coef += c_
            res += r_
        if tree_s is not None and len(surf_pts):
            sel = transform_points(T, surf_pts)
            i_, c_, r_ = _surf_coeffs(sel, tree_s, map_surf, cfg,
                                      weights=surf_w)
            ori += [surf_pts[j] for j in i_]
            coef += c_
            res += r_
        if len(res) < 50:
            break
        pose, conv = lm_step(pose, np.asarray(ori), np.asarray(coef),
                             np.asarray(res), it, lm_state, cfg)
        if conv:
            break
    return pose


def submap_to_submap(pose0, cur_corner, cur_surf, prev_corner, prev_surf,
                     cfg, max_iter=30):
    """subMap2SubMapOptimization (:4485-4540): the same solver registering
    the current submap's clouds (expressed in its own frame) against the
    previous submap's world-frame clouds; <= 30 iterations, uniform
    weights."""
    return scan_to_submap_semantic(
        pose0, cur_corner, None, cur_surf, None, prev_corner, prev_surf,
        cfg, max_iter=max_iter)


def lm_step(pose, pts_ori, coeff, res, iter_count, lm_state, cfg):
    """LMOptimization (:852-974): camera-convention Jacobian, QR solve,
    degeneracy projection at iterCount==0. Mutates lm_state (matP,
    isDegenerate). Returns (new_pose, converged)."""
    srx, crx = np.sin(pose[1]), np.cos(pose[1])
    sry, cry = np.sin(pose[2]), np.cos(pose[2])
    srz, crz = np.sin(pose[0]), np.cos(pose[0])
    m = len(res)
    if m < 50:
        return pose, False

    # lidar -> camera permutation
    px, py, pz = pts_ori[:, 1], pts_ori[:, 2], pts_ori[:, 0]
    cx, cy, cz = coeff[:, 1], coeff[:, 2], coeff[:, 0]
    arx = ((crx * sry * srz * px + crx * crz * sry * py - srx * sry * pz) * cx
           + (-srx * srz * px - crz * srx * py - crx * pz) * cy
           + (crx * cry * srz * px + crx * cry * crz * py - cry * srx * pz) * cz)
    ary = (((cry * srx * srz - crz * sry) * px + (sry * srz + cry * crz * srx) * py
            + crx * cry * pz) * cx
           + ((-cry * crz - srx * sry * srz) * px + (cry * srz - crz * srx * sry) * py
              - crx * sry * pz) * cz)
    arz = (((crz * srx * sry - cry * srz) * px + (-cry * crz - srx * sry * srz) * py) * cx
           + (crx * crz * px - crx * srz * py) * cy
           + ((sry * srz + cry * crz * srx) * px + (crz * sry - cry * srx * srz) * py) * cz)
    A = np.stack([arz, arx, ary, cz, cx, cy], axis=1)
    b = -res
    AtA = A.T @ A
    Atb = A.T @ b
    x = np.linalg.solve(AtA, Atb)

    if iter_count == 0:
        evals, evecs = np.linalg.eigh(AtA)  # ascending
        # cv::eigen is descending; reference checks from the smallest up
        V = evecs[:, ::-1].T  # rows = eigenvectors, descending
        V2 = V.copy()
        lm_state["degenerate"] = False
        for i in range(5, -1, -1):
            if evals[::-1][i] < cfg.matching.degeneracy_eigen_threshold:
                V2[i, :] = 0
                lm_state["degenerate"] = True
            else:
                break
        lm_state["matP"] = np.linalg.inv(V) @ V2

    if lm_state["degenerate"]:
        x = lm_state["matP"] @ x

    new_pose = pose.copy()
    new_pose[:6] += x
    delta_r = np.sqrt(np.sum(np.degrees(x[:3]) ** 2))
    delta_t = np.sqrt(np.sum((x[3:] * 100) ** 2))
    lm_state["deltaR"], lm_state["deltaT"] = delta_r, delta_t
    return new_pose, (delta_r < 0.005 and delta_t < 0.05)


# ---------------------------------------------------------------------------
# the per-scan odometry loop (odomEstimationNode multi-frame-target mode)
# ---------------------------------------------------------------------------

class ReferenceReplicaOdometry:
    """Faithful replay of OdomEstimationNode::laserCloudInfoHandler."""

    def __init__(self, cfg: SlamConfig):
        self.cfg = cfg
        self.pose = np.zeros(6)  # transformTobeMapped
        self.last_pose = np.zeros(6)  # lastTransformTobeMapped
        self.pri_pose = np.zeros(6)  # transformPriFrame
        self.first = True
        self.guess_primed = False  # 'first' flag in the const-vel branch
        self.kf_corner: list[np.ndarray] = []  # laserCloudCornerVec (world)
        self.kf_surf: list[np.ndarray] = []
        self.key_frame_id = 0
        self.lm_state = {"degenerate": False, "matP": np.eye(6),
                         "deltaR": 1e9, "deltaT": 1e9}

    def _update_initial_guess(self):
        # constant-velocity branch (:352-392); no IMU / preint odom here
        if not self.guess_primed:
            self.last_pose = self.pose.copy()
            self.guess_primed = True
            return
        T_back = pose_to_matrix(self.pose)
        T_last = pose_to_matrix(self.last_pose)
        self.last_pose = self.pose.copy()
        T_incr = np.linalg.inv(T_last) @ T_back
        self.pose = matrix_to_pose(pose_to_matrix(self.pose) @ T_incr)

    def _save_keyframe(self, corner, surf):
        T = pose_to_matrix(self.pose)
        self.kf_corner.append(transform_points(T, corner))
        self.kf_surf.append(transform_points(T, surf))
        while len(self.kf_surf) >= self.cfg.keyframe.window_size:
            self.kf_surf.pop(0)
            self.kf_corner.pop(0)
        self.pri_pose = self.pose.copy()
        self.key_frame_id += 1

    def process(self, points: np.ndarray, valid: np.ndarray) -> np.ndarray:
        cfg = self.cfg
        ext = project_and_extract(points, valid, cfg)
        corner, surf = extract_features(ext, cfg)

        self._update_initial_guess()
        if self.first:
            self._save_keyframe(corner, surf)
            self.first = False
            return self.pose.copy()

        # multi-frame target map (:185-207)
        map_corner = pcl_voxel_downsample(
            np.concatenate(self.kf_corner), cfg.voxel.mapping_corner_leaf)
        map_surf = pcl_voxel_downsample(
            np.concatenate(self.kf_surf), cfg.voxel.mapping_surf_leaf)

        # currentCloudInit (:260-281): matched clouds = DS of the FULL clouds
        sharp_corner = pcl_voxel_downsample(corner, cfg.voxel.mapping_corner_leaf)
        sharp_surf = pcl_voxel_downsample(surf, cfg.voxel.mapping_surf_leaf)

        if (len(sharp_corner) > max(cfg.feature.edge_feature_min_valid_num, 0)
                and len(sharp_surf) > cfg.feature.surf_feature_min_valid_num):
            tree_c = cKDTree(map_corner)
            tree_s = cKDTree(map_surf)
            self.lm_state["deltaR"], self.lm_state["deltaT"] = 1e9, 1e9
            for it in range(cfg.matching.max_iterations_frontend):
                T = pose_to_matrix(self.pose)
                cw = transform_points(T, sharp_corner)
                sw = transform_points(T, sharp_surf)
                ci, cc, crs = _corner_coeffs(cw, tree_c, map_corner, cfg)
                si, sc, srs = _surf_coeffs(sw, tree_s, map_surf, cfg)
                pts_ori = np.concatenate([
                    sharp_corner[ci] if ci else np.zeros((0, 3)),
                    sharp_surf[si] if si else np.zeros((0, 3)),
                ])
                coeff = np.asarray(cc + sc).reshape(-1, 3)
                res = np.asarray(crs + srs)
                self.pose, conv = lm_step(
                    self.pose, pts_ori, coeff, res, it, self.lm_state, cfg)
                if conv:
                    break
            # transformUpdate clamps (:976-1006); no IMU slerp here
            rt = cfg.runtime.rotation_tolerance
            zt = cfg.runtime.z_tolerance
            self.pose[0] = np.clip(self.pose[0], -rt, rt)
            self.pose[1] = np.clip(self.pose[1], -rt, rt)
            self.pose[5] = np.clip(self.pose[5], -zt, zt)

        # keyframe gate (:216-228)
        if self.lm_state["deltaR"] < 0.005 or self.lm_state["deltaT"] < 0.05:
            T_incr = (np.linalg.inv(pose_to_matrix(self.pri_pose))
                      @ pose_to_matrix(self.pose))
            inc = matrix_to_pose(T_incr)
            if (self.key_frame_id <= 5
                    or abs(inc[2]) >= cfg.keyframe.min_yaw
                    or abs(inc[3]) >= cfg.keyframe.min_distance
                    or abs(inc[4]) >= cfg.keyframe.min_distance):
                self._save_keyframe(corner, surf)
        return self.pose.copy()


def replay(scans, cfg: SlamConfig) -> np.ndarray:
    """Replay a list of (points (P,4), valid (P,)) scans; returns (n, 6)."""
    odo = ReferenceReplicaOdometry(cfg)
    return np.stack([odo.process(p[:, :3] if p.shape[1] > 3 else p, v)
                     for p, v in scans])
