"""Scan-to-map matching: LOAM point-to-line / point-to-plane Gauss-Newton
(port of lis_slam_tpu/ops/scan_match.py; reference
odomEstimationNode.cpp cornerOptimization :633-747, surfOptimization
:749-827, combineOptimizationCoeffs + LMOptimization :829-974).

Two solvers. `scan_to_map` is a host loop: the JAX `lax.while_loop`, the
drift-triggered cache refresh `lax.cond` and the convergence test become
host branches; the correspondences and the J^T J reduction run on the
device of the clouds, and each iteration brings the 6x6 normal equations
back to the host (one device sync) and solves them there, where the pose
lives. `scan_to_map_scheduled` is the cond-free form with a static
refresh schedule, over a leading lane dim (batched multi-sequence replay):
the pose and every GNState field stay on the device, convergence is a
per-lane mask, and each GN iteration is the H/g build (kernel K2, or the
op-by-op path) and the solve kernel K3 (ops/gn_solve.py), with no host
sync and a launch count that does not grow with the lanes.

The correspondence and normal-equation functions take clouds with or
without leading lane dims.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import MatchingConfig
from ..utils import lin, se3
from . import knn_cuda
from .voxel import _SENTINEL, _voxel_key_morton, lane_sort


class Correspondences(NamedTuple):
    """Weighted residual rows: n . p_world + offset = residual."""

    coeff: torch.Tensor  # (M, 3) weighted direction/normal (s * w * n)
    residual: torch.Tensor  # (M,) weighted signed distance (s * w * dist)
    valid: torch.Tensor  # (M,) bool


def corner_correspondences(pts_world, mask, near, nn_sqd, cfg: MatchingConfig,
                           sem_weight=None) -> Correspondences:
    """Point-to-line residuals via 5-point covariance eigen-analysis."""
    gate = mask & (nn_sqd[..., 4] < cfg.nn_max_sq_dist)
    center = torch.mean(near, dim=-2)
    diff = near - center[..., None, :]
    cov = torch.einsum("...ki,...kj->...ij", diff, diff) / 5.0
    evals = lin.eigvalsh3(cov)
    is_line = evals[..., 2] > cfg.eigen_ratio_line * evals[..., 1]
    direction = lin.principal_eigvec3(cov, evals)
    # residual |(p - c) x u|; coefficient = its unit gradient
    cx = torch.linalg.cross(pts_world - center, direction)
    dist = torch.linalg.vector_norm(cx, dim=-1)
    grad = (torch.linalg.cross(direction, cx)
            / torch.clamp(dist, min=1e-12)[..., None])
    s = 1.0 - cfg.residual_damping * torch.abs(dist)
    w = torch.ones_like(s) if sem_weight is None else sem_weight
    ok = gate & is_line & (s > cfg.min_residual_weight)
    return Correspondences(coeff=(s * w)[..., None] * grad,
                           residual=s * w * dist,
                           valid=ok)


def surf_correspondences(pts_world, mask, near, nn_sqd, cfg: MatchingConfig,
                         sem_weight=None) -> Correspondences:
    """Point-to-plane residuals via a 5-point total-least-squares plane."""
    gate = mask & (nn_sqd[..., 4] < cfg.nn_max_sq_dist)
    n, d = lin.solve_plane_lsq(near)
    plane_res = torch.abs(torch.einsum("...kj,...j->...k", near, n)
                          + d[..., None])
    plane_ok = torch.all(plane_res <= cfg.plane_fit_tolerance, dim=-1)
    pd2 = torch.einsum("...j,...j->...", pts_world, n) + d  # signed distance
    # s = 1 - 0.9 |pd2| / sqrt(|p_world|) (odomEstimationNode.cpp:809)
    range_damp = torch.sqrt(torch.sqrt(
        torch.sum(pts_world * pts_world, dim=-1) + 1e-12))
    s = 1.0 - cfg.residual_damping * torch.abs(pd2) / torch.clamp(
        range_damp, min=1e-6)
    w = torch.ones_like(s) if sem_weight is None else sem_weight
    ok = gate & plane_ok & (s > cfg.min_residual_weight)
    return Correspondences(coeff=(s * w)[..., None] * n,
                           residual=s * w * pd2,
                           valid=ok)


def _rotation_jacobian_mats(rpy: torch.Tensor):
    """d(Rz Ry Rx)/d{roll,pitch,yaw} as three (..., 3, 3) matrices."""
    c, s = torch.cos(rpy), torch.sin(rpy)
    o, z = torch.ones_like(c[..., 0]), torch.zeros_like(c[..., 0])

    def mat(rows):
        return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)

    cr, cp, cy = c[..., 0], c[..., 1], c[..., 2]
    sr, sp, sy = s[..., 0], s[..., 1], s[..., 2]
    Rx = mat([[o, z, z], [z, cr, -sr], [z, sr, cr]])
    Ry = mat([[cp, z, sp], [z, o, z], [-sp, z, cp]])
    Rz = mat([[cy, -sy, z], [sy, cy, z], [z, z, o]])
    dRx = mat([[z, z, z], [z, -sr, -cr], [z, cr, -sr]])
    dRy = mat([[-sp, z, cp], [z, z, z], [-cp, z, -sp]])
    dRz = mat([[-sy, -cy, z], [cy, -sy, z], [z, z, z]])
    return Rz @ Ry @ dRx, Rz @ dRy @ Rx, dRz @ Ry @ Rx


class GNState(NamedTuple):
    """Solver state. scan_to_map keeps the flags and counts as host
    scalars; scan_to_map_scheduled keeps every field as a tensor on the
    device, with a leading lane dim (bool / int32 / float32 (B,))."""

    pose: torch.Tensor  # (6,) [roll,pitch,yaw,x,y,z]
    proj: torch.Tensor  # (6, 6) degeneracy projection matrix
    degenerate: bool
    converged: bool
    n_valid: int
    it: int
    # last-step update magnitudes (deltaR in degrees, deltaT in cm) — the
    # reference's keyframe gate preconditions on these
    # (odomEstimationNode.cpp:216)
    delta_r: float = 0.0
    delta_t: float = 0.0


def normal_equations(M: torch.Tensor, pts_sensor: torch.Tensor,
                     coeff: torch.Tensor, residual: torch.Tensor,
                     valid: torch.Tensor):
    """Weighted Jacobian rows -> (H = J^T J (6,6), g = J^T (-r) (6,),
    n_valid ()). M (3,3,3) holds dR/d{roll,pitch,yaw}. With a leading
    lane dim on every argument, one (H, g, n_valid) per lane."""
    vm = valid[..., None]
    p = torch.where(vm, pts_sensor, torch.zeros_like(pts_sensor))
    c = torch.where(vm, coeff, torch.zeros_like(coeff))
    r = torch.where(valid, residual, torch.zeros_like(residual))
    j_rot = torch.einsum("...mj,...ajk,...mk->...ma", c, M, p)  # (M, 3)
    J = torch.cat([j_rot, c], dim=-1)  # (M, 6)
    Jt = J.transpose(-1, -2)
    g = Jt @ (-r) if J.dim() == 2 else (Jt @ (-r)[..., None])[..., 0]
    return Jt @ J, g, torch.sum(valid.to(torch.int32), dim=-1)


def gn_solve_from_hg(pose: torch.Tensor, H: torch.Tensor, g: torch.Tensor,
                     n_valid: int, cfg: MatchingConfig,
                     eigh=lin.jacobi_eigh6):
    """Solve + degeneracy clamp + convergence test on host (CPU) normal
    equations, the eigendecomposition by `eigh` (the JAX package's cyclic
    Jacobi; kernel K3's plain version passes its round-robin one).
    Returns (new_pose, proj, degenerate, converged, n_valid, delta_r,
    delta_t)."""
    x = lin.solve6_spd(H + 1e-9 * torch.eye(6), g)
    # degeneracy analysis every iteration (the reference only at iteration
    # 0; identical in structurally degenerate scenes)
    evals, evecs = eigh(H)
    keep = (evals >= cfg.degeneracy_eigen_threshold).to(H.dtype)
    proj = evecs @ torch.diag(keep) @ evecs.T
    degenerate = bool(torch.any(keep < 0.5))
    if degenerate:
        x = proj @ x
    enough = n_valid >= cfg.min_valid_points
    if not enough:
        x = torch.zeros_like(x)
    delta_r = float(torch.rad2deg(torch.linalg.vector_norm(x[:3])))
    delta_t = float(100.0 * torch.linalg.vector_norm(x[3:]))
    converged = ((delta_r < cfg.converge_delta_r_deg)
                 and (delta_t < cfg.converge_delta_t_cm)) or not enough
    return pose + x, proj, degenerate, converged, n_valid, delta_r, delta_t


def _solve_on_host(pose, hg, cfg):
    """Bring the packed normal equations [H (36), g (6), n_valid] back in
    ONE device->host copy and solve."""
    hg = hg.cpu()
    return gn_solve_from_hg(pose, hg[:36].reshape(6, 6), hg[36:42],
                            int(hg[42]), cfg)


def gauss_newton_update(pose, pts_sensor, coeff, residual, valid,
                        cfg: MatchingConfig):
    """One LMOptimization step on stacked corner+surf rows (device), solved
    on the host. `pose` is a CPU tensor."""
    M = torch.stack(_rotation_jacobian_mats(pose[:3])).to(pts_sensor.device)
    H, g, n_valid = normal_equations(M, pts_sensor, coeff, residual, valid)
    return _solve_on_host(
        pose, torch.cat([H.reshape(-1), g, n_valid.reshape(1).to(H.dtype)]),
        cfg)


_BIGD = 3e38


def _rerank_neighbors(pts_world, cand_pts, cand_valid, k):
    """Re-rank cached candidates by current distance; return the k nearest
    as (sq_dists (..., Q,k) ascending, slot indices (..., Q,k)), lowest
    slot first on ties (lax.top_k's rule, hence a stable sort and not
    torch.topk)."""
    diff = cand_pts - pts_world[..., None, :]
    d = torch.sum(diff * diff, dim=-1)
    d = torch.where(cand_valid, d, torch.full_like(d, _BIGD))
    d, sel = torch.sort(d, dim=-1, stable=True)
    return d[..., :k], sel[..., :k]


def _morton_sort_queries(pts, mask, weight):
    """Sort a padded query cloud spatially (stable), per lane of leading
    dims; weights ride along."""
    key = torch.where(mask, _voxel_key_morton(pts, mask, 1.0),
                      torch.full(mask.shape, _SENTINEL, dtype=torch.int64,
                                 device=mask.device))
    _, order = lane_sort(key.reshape(-1, key.shape[-1]))
    order = order.reshape(key.shape)

    def take(x):
        return None if x is None else torch.take_along_dim(x, order, -1)

    return (torch.take_along_dim(pts, order[..., None], -2), take(mask),
            take(weight))


def _iteration_update(pose, corner_pts, corner_mask, c_cand, c_ok,
                      surf_pts, surf_mask, s_cand, s_ok,
                      corner_sem_weight, surf_sem_weight, cfg, cache_k):
    """One GN iteration on cached candidates, by cfg.gn_backend: "pallas"
    runs the fused accumulation kernel K2, one launch for both clouds
    (ops/gn_cuda.py); "xla" is the op-by-op path. Both solve through
    gn_solve_from_hg."""
    if cfg.gn_backend == "pallas":
        from . import gn_cuda

        return _solve_on_host(pose, gn_cuda.gn_iteration_vec(
            pose, corner_pts, corner_mask, c_cand, c_ok,
            surf_pts, surf_mask, s_cand, s_ok,
            corner_sem_weight, surf_sem_weight, cfg, cache_k), cfg)
    if cfg.gn_backend != "xla":
        raise ValueError(f"unknown gn_backend {cfg.gn_backend!r}")

    T = se3.pose_to_matrix(pose).to(corner_pts.device)
    cw = se3.transform_points(T, corner_pts)
    sw = se3.transform_points(T, surf_pts)
    cd, csel = _rerank_neighbors(cw, c_cand, c_ok, 5)
    sd, ssel = _rerank_neighbors(sw, s_cand, s_ok, 5)
    c_near = torch.take_along_dim(c_cand, csel[..., None], dim=1)
    s_near = torch.take_along_dim(s_cand, ssel[..., None], dim=1)
    cc = corner_correspondences(cw, corner_mask, c_near, cd, cfg,
                                corner_sem_weight)
    sc = surf_correspondences(sw, surf_mask, s_near, sd, cfg,
                              surf_sem_weight)
    return gauss_newton_update(
        pose, torch.cat([corner_pts, surf_pts]),
        torch.cat([cc.coeff, sc.coeff]), torch.cat([cc.residual, sc.residual]),
        torch.cat([cc.valid, sc.valid]), cfg)


def scan_to_map(pose0: torch.Tensor,
                corner_pts: torch.Tensor, corner_mask: torch.Tensor,
                surf_pts: torch.Tensor, surf_mask: torch.Tensor,
                corner_map: torch.Tensor, corner_map_mask: torch.Tensor,
                surf_map: torch.Tensor, surf_map_mask: torch.Tensor,
                cfg: MatchingConfig, max_iterations: int,
                corner_sem_weight: torch.Tensor | None = None,
                surf_sem_weight: torch.Tensor | None = None,
                cache_k: int | None = None,
                cache_refresh_dist: float | None = None,
                cache_refresh_rot: float | None = None) -> GNState:
    """Full scan-to-map optimization (scan2SubMapOptimization rebuild).

    Neighbor search is the exact kNN (kernel K1 on CUDA, ops/knn_cuda.py)
    over the morton-ordered map buffers; the query clouds are morton-sorted
    once (the GN sums are order-invariant). The cache_k nearest candidates
    are fetched once and re-ranked at the current pose each iteration; the
    cache refreshes when the pose drifts beyond cache_refresh_* from where
    it was built. Returns a GNState whose pose lies on pose0's device.

    Host syncs: one per iteration (the normal equations), at most
    `max_iterations`."""
    if cache_k is None:
        cache_k = cfg.nn_cache_k
    if cache_refresh_dist is None:
        cache_refresh_dist = cfg.nn_cache_refresh_dist
    if cache_refresh_rot is None:
        cache_refresh_rot = cfg.nn_cache_refresh_rot
    dev = corner_pts.device
    corner_pts, corner_mask, corner_sem_weight = _morton_sort_queries(
        corner_pts, corner_mask, corner_sem_weight)
    surf_pts, surf_mask, surf_sem_weight = _morton_sort_queries(
        surf_pts, surf_mask, surf_sem_weight)

    def search(pose):
        T = se3.pose_to_matrix(pose).to(dev)
        cw = se3.transform_points(T, corner_pts)
        sw = se3.transform_points(T, surf_pts)
        # capped at 4.0 m^2: candidates beyond the cache margin are
        # discarded below anyway
        cd, _ci, c_cand = knn_cuda.knn(cw, corner_map, corner_map_mask,
                                       k=cache_k, max_sq_dist=4.0)
        sd, _si, s_cand = knn_cuda.knn(sw, surf_map, surf_map_mask,
                                       k=cache_k, max_sq_dist=4.0)
        return c_cand, cd < 4.0, s_cand, sd < 4.0, pose

    pose = pose0.detach().to("cpu", torch.float32)
    st = GNState(pose=pose, proj=torch.eye(6), degenerate=False,
                 converged=False, n_valid=0, it=0)
    cache = search(pose)
    while st.it < max_iterations and not st.converged:
        cache_pose = cache[4]
        moved = (float(torch.linalg.vector_norm(st.pose[3:] - cache_pose[3:]))
                 > cache_refresh_dist
                 or float(torch.linalg.vector_norm(st.pose[:3]
                                                   - cache_pose[:3]))
                 > cache_refresh_rot)
        if moved:
            cache = search(st.pose)
        c_cand, c_ok, s_cand, s_ok, _ = cache
        new_pose, proj, degen, conv, n_valid, d_r, d_t = _iteration_update(
            st.pose, corner_pts, corner_mask, c_cand, c_ok,
            surf_pts, surf_mask, s_cand, s_ok,
            corner_sem_weight, surf_sem_weight, cfg, cache_k)
        st = GNState(pose=new_pose, proj=proj, degenerate=degen,
                     converged=conv, n_valid=n_valid, it=st.it + 1,
                     delta_r=d_r, delta_t=d_t)
    return st._replace(pose=st.pose.to(pose0.device))



def _normal_equations_lanes(pose, corner_pts, corner_mask, c_cand, c_ok,
                            surf_pts, surf_mask, s_cand, s_ok,
                            corner_sem_weight, surf_sem_weight, cfg):
    """The op-by-op ("xla") H/g build of one GN iteration for B lanes, on
    the device: the packed (B, 43) normal equations. Its batched products
    (einsums, J^T J) go through cuBLAS, whose rounding depends on the
    lane count; the "pallas" path has none."""
    T = se3.pose_to_matrix(pose)
    cw = se3.transform_points_lanes(T, corner_pts)
    sw = se3.transform_points_lanes(T, surf_pts)
    cd, csel = _rerank_neighbors(cw, c_cand, c_ok, 5)
    sd, ssel = _rerank_neighbors(sw, s_cand, s_ok, 5)
    c_near = torch.take_along_dim(c_cand, csel[..., None], dim=-2)
    s_near = torch.take_along_dim(s_cand, ssel[..., None], dim=-2)
    cc = corner_correspondences(cw, corner_mask, c_near, cd, cfg,
                                corner_sem_weight)
    sc = surf_correspondences(sw, surf_mask, s_near, sd, cfg,
                              surf_sem_weight)
    M = torch.stack(_rotation_jacobian_mats(pose[:, :3]), dim=1)
    H, g, n_valid = normal_equations(
        M, torch.cat([corner_pts, surf_pts], dim=1),
        torch.cat([cc.coeff, sc.coeff], dim=1),
        torch.cat([cc.residual, sc.residual], dim=1),
        torch.cat([cc.valid, sc.valid], dim=1))
    return torch.cat([H.reshape(-1, 36), g,
                      n_valid[:, None].to(H.dtype)], dim=1)


def scan_to_map_scheduled(pose0: torch.Tensor,
                          corner_pts: torch.Tensor, corner_mask: torch.Tensor,
                          surf_pts: torch.Tensor, surf_mask: torch.Tensor,
                          corner_map: torch.Tensor,
                          corner_map_mask: torch.Tensor,
                          surf_map: torch.Tensor, surf_map_mask: torch.Tensor,
                          cfg: MatchingConfig, n_iters: int,
                          refresh_iters: tuple[int, ...] = (2, 5),
                          corner_sem_weight: torch.Tensor | None = None,
                          surf_sem_weight: torch.Tensor | None = None,
                          cache_k: int | None = None) -> GNState:
    """Cond-free scan-to-map optimization with a STATIC refresh schedule
    (lis_slam_tpu/ops/scan_match.py:scan_to_map_scheduled), over lanes.

    Same math as scan_to_map, but the control flow is fixed: `n_iters`
    iterations, the neighbour cache searched at the start and again before
    each iteration in `refresh_iters`, and masked updates after
    convergence (a converged lane stays frozen; `it` counts its active
    iterations) in place of the early exit. Every argument may carry a
    leading lane dim B (pose0 (B, 6), clouds (B, Q, 3), maps (B, N, 3)),
    and then every GNState field does too (bool / int32 / float32 (B,),
    pose (B, 6), proj (B, 6, 6)); without it, one lane.

    Everything stays on the clouds' device and nothing waits on it: per
    search one K1 launch for each cloud (ops/knn_cuda.knn_lanes), per GN
    iteration the H/g build by cfg.gn_backend ("pallas": one K2 launch,
    ops/gn_cuda.gn_iteration_lanes, with the scalar rows K3 wrote;
    "xla": the op-by-op path) and one K3 launch (ops/gn_solve.solve), the
    same launches for any B. The queries are morton-sorted per lane first
    (the GN sums are order-invariant)."""
    from . import gn_cuda, gn_solve

    one = pose0.dim() == 1
    if one:
        lift = [None if t is None else t[None] for t in (
            pose0, corner_pts, corner_mask, surf_pts, surf_mask, corner_map,
            corner_map_mask, surf_map, surf_map_mask, corner_sem_weight,
            surf_sem_weight)]
        st = scan_to_map_scheduled(*lift[:9], cfg, n_iters, refresh_iters,
                                   *lift[9:], cache_k=cache_k)
        return GNState(*(t[0] for t in st))
    if cfg.gn_backend not in ("pallas", "xla"):
        raise ValueError(f"unknown gn_backend {cfg.gn_backend!r}")
    if cache_k is None:
        cache_k = cfg.nn_cache_k
    corner_pts, corner_mask, corner_sem_weight = _morton_sort_queries(
        corner_pts, corner_mask, corner_sem_weight)
    surf_pts, surf_mask, surf_sem_weight = _morton_sort_queries(
        surf_pts, surf_mask, surf_sem_weight)
    maps = [t.contiguous() for t in (corner_map, corner_map_mask, surf_map,
                                     surf_map_mask)]

    def search():
        # "pallas" searches at the rotation and translation of K2's scalar
        # rows (which K3 wrote), the transform its H/g build applies;
        # "xla" at its own transform of the pose
        T = (se3.make_transform(rows[:, 0, :9].reshape(-1, 3, 3),
                                rows[:, 0, 9:12]) if pallas
             else se3.pose_to_matrix(st.pose))
        # capped at 4.0 m^2: candidates beyond the cache margin are
        # discarded below anyway
        cd, _ci, c_cand = knn_cuda.knn_lanes(
            se3.transform_points_lanes(T, corner_pts), maps[0], maps[1],
            k=cache_k, max_sq_dist=4.0)
        sd, _si, s_cand = knn_cuda.knn_lanes(
            se3.transform_points_lanes(T, surf_pts), maps[2], maps[3],
            k=cache_k, max_sq_dist=4.0)
        return c_cand, cd < 4.0, s_cand, sd < 4.0

    st = gn_solve.init_state(pose0)
    pallas = cfg.gn_backend == "pallas"
    rows = gn_solve.scalar_rows(st, cfg) if pallas else None
    cache = search()
    for i in range(n_iters):
        if i in refresh_iters:
            cache = search()
        c_cand, c_ok, s_cand, s_ok = cache
        if pallas:
            hg = gn_cuda.gn_iteration_lanes(
                rows, corner_pts, corner_mask, c_cand, c_ok, surf_pts,
                surf_mask, s_cand, s_ok, corner_sem_weight, surf_sem_weight,
                cache_k)
        else:
            hg = _normal_equations_lanes(
                st.pose, corner_pts, corner_mask, c_cand, c_ok, surf_pts,
                surf_mask, s_cand, s_ok, corner_sem_weight, surf_sem_weight,
                cfg)
        st, rows = gn_solve.solve(hg.contiguous(), st, cfg)
    return st
