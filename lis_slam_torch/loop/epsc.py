"""EPSC-family place-recognition descriptors and loop detection (port of
lis_slam_tpu/loop/epsc.py; reference src/core/epscGeneration.cpp):
polar-grid descriptors (SC :403-445, ISC :447-476, EPSC :478-520, SEPSC
:522-562, SSC :564-588, FEPSC :591-607), the 360-sector semantic signature
(project :84-120), signature alignment + 2-D ICP (globalICP :258-401),
scoring with a +-10-sector search (calculateDistance :633-660,
calculateLabelSim :611-631), and the travel/inflation candidate gate
(loopDetection :736-740).

Every function takes an optional leading batch dimension on the cloud
coordinates (the candidates of one keyframe), where the JAX module vmaps.
The scatters are deterministic: `.at[].max` is `scatter_reduce("amax")`
on a zero start, and the signature's `.at[].set` with several points in
one sector keeps the HIGHEST source index, which is what the JAX package
keeps on the CPU (tests/test_torch_epsc.py) and what a sequential scatter
does; CUDA's `index_put_` with duplicates promises no winner.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..config import DescriptorType, LoopClosureConfig
from ..labels import SSC_ORDER, USING_LABEL_MAP
from ..utils import se3

_SIG_SECTORS = 360
# learning-class ids of the 1-D signature (project(): building, fence,
# trunk, pole, traffic-sign)
_SIG_CLASSES = (13, 14, 16, 18, 19)


class Descriptors(NamedTuple):
    sc: torch.Tensor  # ([B,] R, S) max quantized height
    isc: torch.Tensor  # max intensity (0..255)
    epsc: torch.Tensor  # 100*surf/(1+edge)
    sepsc: torch.Tensor  # semantic planar/edge ratio
    ssc: torch.Tensor  # priority label
    fepsc: torch.Tensor  # fused
    signature: torch.Tensor  # ([B,] 360, 4) [count, x, y, label]


def _flat_index(idx: torch.Tensor, n_out: int) -> torch.Tensor:
    """(B, N) bin ids in [0, n_out] -> flat ids of a (B, n_out + 1) grid."""
    off = torch.arange(idx.shape[0], device=idx.device)[:, None] * (n_out + 1)
    return (idx.to(torch.int64) + off).reshape(-1)


def _scatter_max(idx, val, n_out: int):
    """zeros(B, n_out + 1).at[idx].max(val)[:, :n_out]."""
    b = idx.shape[0]
    out = torch.zeros(b * (n_out + 1), dtype=val.dtype, device=val.device)
    out = out.scatter_reduce(0, _flat_index(idx, n_out), val.reshape(-1),
                             "amax", include_self=True)
    return out.reshape(b, n_out + 1)[:, :n_out]


def _count(idx, n_out: int):
    """zeros(B, n_out + 1).at[idx].add(1.0)[:, :n_out]."""
    b = idx.shape[0]
    c = torch.bincount(_flat_index(idx, n_out), minlength=b * (n_out + 1))
    return c.reshape(b, n_out + 1)[:, :n_out].to(torch.float32)


def _scatter_last(idx, vals, n_out: int):
    """zeros(B, n_out + 1).at[idx].set(v)[:, :n_out] for each (B, N) column
    of `vals`, the highest source index winning each bin."""
    b, n = idx.shape
    src = torch.arange(n, device=idx.device).expand(b, n)
    win = torch.full((b * (n_out + 1),), -1, dtype=torch.int64,
                     device=idx.device)
    win = win.scatter_reduce(0, _flat_index(idx, n_out), src.reshape(-1),
                             "amax", include_self=True)
    win = win.reshape(b, n_out + 1)[:, :n_out]
    g = torch.clamp(win, min=0)
    return [torch.where(win >= 0, torch.gather(v, 1, g), torch.zeros_like(
        g, dtype=v.dtype)) for v in vals]


def _polar_bins(xy: torch.Tensor, cfg: LoopClosureConfig):
    d = torch.sqrt(xy[..., 0] ** 2 + xy[..., 1] ** 2)
    ring_step = (cfg.max_dis - cfg.min_dis) / cfg.rings
    sector_step = 2.0 * math.pi / cfg.sectors
    ring = torch.floor((d - cfg.min_dis) / ring_step).to(torch.int32)
    ang = math.pi + torch.atan2(xy[..., 1], xy[..., 0])
    sector = torch.floor(ang / sector_step).to(torch.int32)
    ok = ((d >= cfg.min_dis) & (d < cfg.max_dis) & (ring >= 0)
          & (ring < cfg.rings) & (sector >= 0) & (sector < cfg.sectors))
    return ring, sector, ok


def _ratio(num, den):
    r = torch.floor(100.0 * torch.clamp(num, max=255.0)
                    / (1.0 + torch.clamp(den, max=255.0)))
    return torch.clamp(r, max=255.0)


def compute_descriptors(sem_xyz, sem_intensity, sem_label, sem_valid,
                        corner_xyz, corner_valid, surf_xyz, surf_valid,
                        cfg: LoopClosureConfig) -> Descriptors:
    """All six families and the signature of one keyframe's clouds (sensor
    frame): sem (P, 3) with intensity, learning-class label and validity;
    the LOAM corner and surf clouds. The xyz tensors may carry a leading
    batch dim B (the same points under B transforms)."""
    batched = sem_xyz.dim() == 3
    if not batched:
        sem_xyz, corner_xyz, surf_xyz = (x[None] for x in (
            sem_xyz, corner_xyz, surf_xyz))
    b = sem_xyz.shape[0]
    dev = sem_xyz.device
    R, S = cfg.rings, cfg.sectors
    n = R * S

    def cell_ids(xyz, valid):
        ring, sector, ok = _polar_bins(xyz[..., :2], cfg)
        return torch.where(valid & ok, ring * S + sector,
                           torch.full_like(ring, n))

    sem_cell = cell_ids(sem_xyz, sem_valid)
    zq = torch.floor(100.0 * (sem_xyz[..., 2] + cfg.lidar_height) / 8.0)
    sc = torch.clamp(_scatter_max(sem_cell, zq, n), min=0.0)
    iq = torch.floor(255.0 * torch.clamp(sem_intensity, 0.0, 1.0))
    isc = _scatter_max(sem_cell, iq.expand(b, -1), n)
    epsc = _ratio(_count(cell_ids(surf_xyz, surf_valid), n),
                  _count(cell_ids(corner_xyz, corner_valid), n))

    lab = torch.clamp(sem_label, 0, 19).long()
    ulab = torch.as_tensor(USING_LABEL_MAP, device=dev)[lab]
    planar = (ulab == 40) | (ulab == 50)
    edge = ulab == 81
    full = torch.full_like(sem_cell, n)
    sepsc = _ratio(_count(torch.where(planar, sem_cell, full), n),
                   _count(torch.where(edge, sem_cell, full), n))
    order = torch.as_tensor(SSC_ORDER, dtype=torch.int32, device=dev)[lab]
    packed = (order * 256 + sem_label.to(torch.int32)).expand(b, -1)
    ssc = _scatter_max(torch.where(order > 0, sem_cell, full), packed, n) % 256
    fepsc = torch.floor(sepsc * 0.4 + epsc * 0.6)

    # 1-D signature over 360 sectors of the structural classes
    x, y = sem_xyz[..., 0], sem_xyz[..., 1]
    d = torch.sqrt(x ** 2 + y ** 2)
    ang = math.pi + torch.atan2(y, x)
    sec = torch.floor(ang / (2.0 * math.pi / _SIG_SECTORS)).to(torch.int32)
    is_sig = torch.zeros_like(sem_valid)
    for c in _SIG_CLASSES:
        is_sig = is_sig | (sem_label == c)
    ok = (sem_valid & is_sig & (d > 1e-2) & (sec >= 0)
          & (sec < _SIG_SECTORS))
    dest = torch.where(ok, sec, torch.full_like(sec, _SIG_SECTORS))
    sx, sy, sl = _scatter_last(dest, (x, y, sem_label.to(torch.float32)
                                      .expand(b, -1)), _SIG_SECTORS)
    signature = torch.stack([_count(dest, _SIG_SECTORS), sx, sy, sl], dim=-1)

    def rs(a):
        a = a.reshape(b, R, S).to(torch.float32)
        return a if batched else a[0]

    return Descriptors(sc=rs(sc), isc=rs(isc), epsc=rs(epsc),
                       sepsc=rs(sepsc), ssc=rs(ssc), fepsc=rs(fepsc),
                       signature=signature if batched else signature[0])


def _roll_cols(a: torch.Tensor, shifts: torch.Tensor) -> torch.Tensor:
    """For a (B, ..., S) tensor and (B, K) shifts: (B, K, ..., S) with
    out[b, k, ..., j] = a[b, ..., (j + shifts[b, k]) mod S], i.e.
    jnp.roll(a, -shift, axis=-1)."""
    s = a.shape[-1]
    j = torch.arange(s, device=a.device)
    idx = torch.remainder(j + shifts[..., None], s)  # (B, K, S)
    extra = a.dim() - 2
    idx = idx.reshape(idx.shape[:2] + (1,) * extra + (s,))
    idx = idx.expand((a.shape[0], shifts.shape[1]) + a.shape[1:])
    return torch.gather(a[:, None].expand_as(idx), -1, idx)


def descriptor_distance(desc1, desc2, init_angle, cfg: LoopClosureConfig):
    """calculateDistance: best mean-|diff| over the +-rotation_search
    column shifts of desc2; (B, R, S) each, init_angle (B,). Returns
    (score = 1 - diff (B,), refined angle (B,)); ties go to the first
    shift."""
    shifts = torch.arange(-cfg.rotation_search, cfg.rotation_search,
                          device=desc1.device)
    rolled = _roll_cols(desc2, shifts.expand(desc2.shape[0], -1))
    diffs = torch.mean(torch.abs(desc1[:, None] - rolled), dim=(-2, -1)) / 255.0
    best = torch.argmin(diffs, dim=1)
    score = 1.0 - torch.gather(diffs, 1, best[:, None])[:, 0]
    angle = init_angle + shifts[best].to(torch.float32) * (
        2.0 * math.pi / cfg.sectors)
    return score, angle


def label_similarity(desc1, desc2):
    """calculateLabelSim for SSC, per batch row: the matching fraction of
    the cells that are non-empty in either descriptor."""
    nonzero = (desc1 != 0) | (desc2 != 0)
    match = (desc1 == desc2) & nonzero
    dims = (-2, -1)
    return (torch.sum(match, dim=dims).to(torch.float32)
            / torch.clamp(torch.sum(nonzero, dim=dims), min=1))


def _icp_2d(src, src_valid, dst, dst_valid, iterations: int = 10):
    """2-D point-to-point rigid ICP (the PCL ICP inside globalICP); src,
    dst (B, N, 2). Returns (R (B,2,2), t (B,2))."""
    b = src.shape[0]
    Rm = torch.eye(2, device=src.device).expand(b, 2, 2)
    t = torch.zeros((b, 2), device=src.device)
    for _ in range(iterations):
        moved = src @ Rm.transpose(1, 2) + t[:, None, :]
        d2 = torch.sum((moved[:, :, None, :] - dst[:, None, :, :]) ** 2, -1)
        d2 = torch.where(dst_valid[:, None, :], d2, torch.full_like(d2, 1e18))
        nnd, nn = torch.min(d2, dim=2)
        w = (src_valid & (nnd < 25.0)).to(torch.float32)
        tgt = torch.gather(dst, 1, nn[..., None].expand(-1, -1, 2))
        wsum = torch.clamp(torch.sum(w, 1), min=1.0)
        mu_s = torch.sum(moved * w[..., None], 1) / wsum[:, None]
        mu_t = torch.sum(tgt * w[..., None], 1) / wsum[:, None]
        A = ((moved - mu_s[:, None]) * w[..., None]).transpose(1, 2) @ (
            tgt - mu_t[:, None])
        theta = torch.atan2(A[:, 0, 1] - A[:, 1, 0], A[:, 0, 0] + A[:, 1, 1])
        c, s = torch.cos(theta), torch.sin(theta)
        dR = torch.stack([torch.stack([c, -s], -1), torch.stack([s, c], -1)],
                         -2)
        Rm = dR @ Rm
        t = (dR @ (t - mu_s)[..., None])[..., 0] + mu_t
    return Rm, t


def global_icp(sig1, sig2, yaw_diff):
    """globalICP: rotation by signature-count alignment (+-30 sectors
    around the odometry yaw difference), then 2-D ICP on the sector sample
    points. sig1 (B, 360, 4) candidates, sig2 (360, 4) current, yaw_diff
    (B,). Returns (R2 (B,2,2), t2 (B,2), yaw (B,), valid (B,))."""
    b = sig1.shape[0]
    dev = sig1.device
    step = 2.0 * math.pi / _SIG_SECTORS
    tmp_id = torch.floor(torch.remainder(yaw_diff, 2.0 * math.pi) / step).to(
        torch.int64)
    sig2 = sig2.expand(b, -1, -1)
    shifts = torch.arange(-30, 30, device=dev)
    rolled = _roll_cols(sig2[..., 0], tmp_id[:, None] + shifts[None])
    costs = torch.sum(torch.abs(sig1[:, None, :, 0] - rolled), dim=-1)
    best = torch.argmin(costs, dim=1)
    angle = (tmp_id + shifts[best]).to(torch.float32) * step
    c, s = torch.cos(angle), torch.sin(angle)
    rot = torch.stack([torch.stack([c, -s], -1), torch.stack([s, c], -1)], -2)
    src = sig2[..., 1:3] @ rot.transpose(1, 2)
    src_valid = sig2[..., 3] > 0
    Ricp, ticp = _icp_2d(src, src_valid, sig1[..., 1:3], sig1[..., 3] > 0)
    R_total = Ricp @ rot
    yaw = torch.atan2(R_total[:, 1, 0], R_total[:, 0, 0])
    return R_total, ticp, yaw, torch.sum(src_valid, dim=1) > 10


def select_descriptor(d: Descriptors, dtype: DescriptorType) -> torch.Tensor:
    """The configured descriptor family (the Using*Flag switch)."""
    return {DescriptorType.SC: d.sc, DescriptorType.ISC: d.isc,
            DescriptorType.EPSC: d.epsc, DescriptorType.SEPSC: d.sepsc,
            DescriptorType.SSC: d.ssc, DescriptorType.FEPSC: d.fepsc,
            DescriptorType.POSE: d.fepsc}[dtype]


class CloudRefs(NamedTuple):
    """One keyframe's descriptor input clouds, sensor frame, on the
    device (what loopDetection re-projects per candidate,
    epscGeneration.cpp:806-860)."""

    sem_xyz: torch.Tensor
    sem_intensity: torch.Tensor
    sem_label: torch.Tensor
    sem_valid: torch.Tensor
    corner_xyz: torch.Tensor
    corner_valid: torch.Tensor
    surf_xyz: torch.Tensor
    surf_valid: torch.Tensor


def loop_score_batch(cand_descs, cand_sigs, cur_sig, yaw_diffs,
                     clouds: CloudRefs, cfg: LoopClosureConfig):
    """All candidates of one keyframe at once (loopDetection,
    epscGeneration.cpp:663-992): signature alignment, the current cloud's
    descriptor recomputed under each candidate's alignment, scoring, and
    the best candidate. Returns device tensors (best, score, angle, t2,
    any_ok) and waits on nothing."""
    R2s, t2s, yaws, oks = global_icp(cand_sigs, cur_sig, yaw_diffs)
    c = R2s.shape[0]
    T2 = torch.eye(4, device=R2s.device).repeat(c, 1, 1)
    T2[:, :2, :2] = R2s
    T2[:, :2, 3] = t2s
    d_cur = compute_descriptors(
        se3.transform_points(T2, clouds.sem_xyz), clouds.sem_intensity,
        clouds.sem_label, clouds.sem_valid,
        se3.transform_points(T2, clouds.corner_xyz), clouds.corner_valid,
        se3.transform_points(T2, clouds.surf_xyz), clouds.surf_valid, cfg)
    sel = select_descriptor(d_cur, cfg.descriptor)
    if cfg.descriptor == DescriptorType.SSC:
        scores, angles = label_similarity(cand_descs, sel), yaws
        thresh = cfg.label_threshold
    else:
        scores, angles = descriptor_distance(cand_descs, sel, yaws, cfg)
        thresh = cfg.distance_threshold
    ok = oks & (scores > thresh)
    best = torch.argmax(torch.where(ok, scores, torch.full_like(scores, -1.0)))
    return best, scores[best], angles[best], t2s[best], torch.any(ok)


class LoopCandidate(NamedTuple):
    matched_id: int
    score: float
    transform: np.ndarray  # (4, 4) SE(3), z = 0, roll = pitch = 0


class LoopDetector:
    """Host-side candidate gate + the device-resident descriptor database
    (EPSCGeneration::loopDetection)."""

    def __init__(self, cfg: LoopClosureConfig):
        self.cfg = cfg
        # past cfg.max_keyframes stored payloads only the host pose/travel
        # bookkeeping is kept (entries hold None)
        self.descs: list[torch.Tensor | None] = []  # selected (R, S)
        self.sigs: list[torch.Tensor | None] = []  # (360, 4)
        self.poses: list[np.ndarray] = []  # (x, y, yaw)
        self.travel: list[float] = []
        self._n_stored = 0

    def gate(self, pose_xyyaw: np.ndarray) -> np.ndarray:
        """Travelled > skip_neighbor_distance and position error < travel x
        inflation_covariance; nearest first, at most max_candidates."""
        cfg = self.cfg
        cur_id = len(self.poses)
        if not cur_id:
            return np.empty(0, np.int64)
        last_travel = self.travel[-1] + float(
            np.linalg.norm(pose_xyyaw[:2] - self.poses[-1][:2]))
        poses_np = np.asarray(self.poses)
        delta_travel = last_travel - np.asarray(self.travel)[:cur_id]
        pos_dist = np.linalg.norm(pose_xyyaw[None, :2] - poses_np[:cur_id, :2],
                                  axis=1)
        ok = (delta_travel > cfg.skip_neighbor_distance) & (
            pos_dist < delta_travel * cfg.inflation_covariance)
        ids = np.nonzero(ok)[0]
        if len(ids):
            ids = ids[np.array([self.descs[i] is not None for i in ids],
                               dtype=bool)]
        return ids[np.argsort(pos_dist[ids])][: cfg.max_candidates]

    def score_async(self, ids: np.ndarray, cur_sig: torch.Tensor,
                    clouds: CloudRefs, pose_xyyaw: np.ndarray):
        """Launch the batched scoring (padded to max_candidates with the
        first id); returns its device tensors without waiting."""
        pad = self.cfg.max_candidates - len(ids)
        ids_p = np.concatenate([ids, np.repeat(ids[:1], pad)])
        yaw = torch.as_tensor(
            pose_xyyaw[2] - np.asarray(self.poses)[ids_p, 2],
            dtype=torch.float32).to(cur_sig.device)
        return loop_score_batch(
            torch.stack([self.descs[i] for i in ids_p]),
            torch.stack([self.sigs[i] for i in ids_p]), cur_sig, yaw,
            clouds, self.cfg)

    @staticmethod
    def result_to_candidate(ids: np.ndarray, fetched) -> LoopCandidate | None:
        """A fetched score_async result (host values) -> LoopCandidate."""
        best_j, score, angle, t2, any_ok = fetched
        if not bool(any_ok):
            return None
        T = np.eye(4)
        ca, sa = np.cos(float(angle)), np.sin(float(angle))
        T[:2, :2] = [[ca, -sa], [sa, ca]]
        T[:2, 3] = np.asarray(t2)
        return LoopCandidate(matched_id=int(ids[int(best_j)]),
                             score=float(score), transform=T)

    def append(self, desc_sel: torch.Tensor, sig: torch.Tensor,
               pose_xyyaw: np.ndarray):
        """Insert the current keyframe into the database."""
        if self.travel:
            self.travel.append(self.travel[-1] + float(
                np.linalg.norm(pose_xyyaw[:2] - self.poses[-1][:2])))
        else:
            self.travel.append(0.0)
        keep = self._n_stored < self.cfg.max_keyframes
        self.descs.append(desc_sel if keep else None)
        self.sigs.append(sig if keep else None)
        self._n_stored += keep
        self.poses.append(np.asarray(pose_xyyaw, dtype=np.float64))

    def add_and_detect(self, desc: Descriptors, pose_xyyaw: np.ndarray,
                       clouds: CloudRefs) -> list[LoopCandidate]:
        """Gate, score (waiting for the result) and append, in one call.
        The SLAM pipeline uses the asynchronous pieces directly."""
        ids = self.gate(pose_xyyaw)
        best = None
        if len(ids):
            res = self.score_async(ids, desc.signature, clouds, pose_xyyaw)
            best = self.result_to_candidate(
                ids, tuple(r.cpu().numpy() for r in res))
        self.append(select_descriptor(desc, self.cfg.descriptor),
                    desc.signature, pose_xyyaw)
        return [best] if best is not None else []
