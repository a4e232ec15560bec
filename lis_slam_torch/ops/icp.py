"""Gauss-Newton ICP on SE(3) and the fitness score (port of
lis_slam_tpu/ops/icp.py `icp` and `fitness_score`; reference
registration.cpp OptimizedICPGN::Match :19-86, GetFitnessScore :90-115).

The JAX `lax.while_loop` becomes a host loop: the correspondences and the
6x6 normal equations are built on the clouds' device, and each iteration
brings (H, g, inlier count, squared-residual sum) back in ONE device->host
copy; the solve, the SE(3) update and the exit test run on the host in
float32, as the JAX program does them on the device. The exit semantics
are the JAX ones, including `done` deferred to the last refresh iteration
and the zeroed neighbor cache of a `refresh_iters` that lacks 0.

NDT and `select_registration_method` are not ported: no path of the port
runs them.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils import lin, se3
from . import knn


class ICPResult(NamedTuple):
    transform: torch.Tensor  # (4, 4) source -> target, on the host
    converged: bool
    fitness: float  # mean squared correspondence residual
    n_inliers: int
    iterations: int


def _normal_equations(moved, normal, resid, w):
    """J_i = w_i [n_i, p_i x n_i] (translation, rotation), r_i = w_i res_i:
    returns the (6,6) J^T J and the (6,) J^T (-r)."""
    J = torch.cat([normal * w[:, None],
                   torch.linalg.cross(moved, normal) * w[:, None]], dim=1)
    return J.T @ J, J.T @ (-(resid * w))


def icp(src: torch.Tensor, src_mask: torch.Tensor, tgt: torch.Tensor,
        tgt_hash: knn.VoxelHashMap, init_T: torch.Tensor,
        max_correspond_dist: float = 1.0, max_iterations: int = 30,
        point_to_plane: bool = False, trans_eps: float = 1e-4,
        refresh_iters: tuple = ()) -> ICPResult:
    """GN ICP. point_to_plane fits a plane through the 5 hash neighbors.

    `refresh_iters`: the iterations at which the hash k-NN runs; in
    between, the cached neighbor indices are re-evaluated at the current
    pose. `()` searches every iteration. Host syncs: one per iteration."""
    dev = src.device
    kk = 5 if point_to_plane else 1
    last_refresh = max(refresh_iters) if refresh_iters else 0
    T = init_T.detach().to("cpu", torch.float32)
    idx = torch.zeros((src.shape[0], kk), dtype=torch.int64, device=dev)
    it, done, fit, n_in = 0, False, 1e9, 0
    eye6 = torch.eye(6)
    while it < max_iterations and not done:
        moved = se3.transform_points(T.to(dev), src)
        if not refresh_iters or it in refresh_iters:
            idx = knn.knn_hash(moved, tgt_hash, k=kk)[1]
        near = tgt[idx]  # (N, kk, 3)
        d2 = torch.sum((moved[:, None, :] - near) ** 2, dim=-1)
        gate = max_correspond_dist ** 2
        if point_to_plane:
            normal, d_off = lin.solve_plane_lsq(near)
            resid = torch.einsum("nj,nj->n", moved, normal) + d_off
            ok = src_mask & (torch.amax(d2, dim=1) < gate)
        else:
            diff = moved - near[:, 0]
            dist = torch.sqrt(torch.clamp(d2[:, 0], min=1e-12))
            normal = diff / dist[:, None]
            resid = dist
            ok = src_mask & (d2[:, 0] < gate)
        # rows without a valid plane can carry NaN normals: zero them
        ok = ok & torch.all(torch.isfinite(normal), dim=-1) & torch.isfinite(
            resid)
        normal = torch.where(ok[:, None], normal, torch.zeros_like(normal))
        resid = torch.where(ok, resid, torch.zeros_like(resid))
        w = ok.to(torch.float32)
        H, g = _normal_equations(moved, normal, resid, w)
        stats = torch.cat([H.reshape(-1), g,
                           torch.sum(ok.to(torch.int32)).reshape(1).to(H),
                           torch.sum(w * resid * resid).reshape(1)]).cpu()
        n_in = int(stats[42])
        enough = n_in >= 10
        dx = lin.solve6_spd(stats[:36].reshape(6, 6) + 1e-8 * eye6,
                            stats[36:42])
        if not enough:
            dx = torch.zeros(6)
        T = se3.se3_exp(dx) @ T
        fit = float(stats[43] / max(n_in, 1))
        done = ((float(torch.linalg.vector_norm(dx)) < trans_eps
                 and it >= last_refresh) or not enough)
        it += 1
    return ICPResult(transform=T, converged=done and n_in >= 10,
                     fitness=fit, n_inliers=n_in, iterations=it)


def fitness_score(src: torch.Tensor, src_mask: torch.Tensor,
                  tgt_hash: knn.VoxelHashMap, T: torch.Tensor,
                  max_range: float = 25.0) -> torch.Tensor:
    """Mean squared 1-NN distance of the aligned source (capped at
    max_range), a () tensor on the source's device."""
    moved = se3.transform_points(T.to(src), src)
    d, _ = knn.knn_hash(moved, tgt_hash, k=1)
    ok = src_mask & (d[:, 0] < max_range ** 2)
    return torch.sum(torch.where(ok, d[:, 0], torch.zeros_like(d[:, 0]))) / (
        torch.clamp(torch.sum(ok.to(torch.int32)), min=1))
