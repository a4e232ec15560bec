"""Fused Gauss-Newton accumulation: kernel K2 and its plain version.

Port of lis_slam_tpu/ops/pallas_gn.py (`gn_partials`, the Pallas TPU
kernel `_gn_kernel`, `pack_scalars`, `gn_iteration_hg`). The kernel is CUDA
C++ in csrc/gn.cu — see its header for what bounds it on the H100 and how
its design answers. `gn_partials` takes the plain PyTorch version for
tensors on the CPU and launches the kernel for CUDA tensors; it never falls
back.

The plain version is the op-by-op ("xla" backend) math of
scan_match._iteration_update for ONE cloud — transform, stable re-rank,
gather, corner/surf correspondences — reduced to (H, g, n_valid).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from ..config import MatchingConfig
from ..utils import se3
from . import cuda_build, scan_match

KERNEL_K = (8, 10)  # k values (nn_cache_k) csrc/gn.cu instantiates
_FLAGS = ("--fmad=false",)  # products round as in the plain version

# scalar row layout (as pallas_gn.py:47-59): [0:9] rotation row-major,
# [9:12] translation, [12:39] dR/droll, dR/dpitch, dR/dyaw row-major,
# then nn_max_sq_dist, residual_damping, min_residual_weight, and
# eigen_ratio_line (corner) / plane_fit_tolerance (surf)
_SC_M = 12
_SC_GATES = 39
# (6,6) H from the 21 upper-triangle sums, row-major
_SYM_INDEX = [min(i, j) * 6 - min(i, j) * (min(i, j) - 1) // 2
              + abs(i - j) for i in range(6) for j in range(6)]


def pack_scalars(pose: torch.Tensor, cfg: MatchingConfig,
                 mode: str) -> torch.Tensor:
    """The (64,) float32 scalar row for `gn_partials`, on pose's device."""
    R = se3.euler_to_rot(pose[:3])
    M_roll, M_pitch, M_yaw = scan_match._rotation_jacobian_mats(pose[:3])
    gate = (cfg.eigen_ratio_line if mode == "corner"
            else cfg.plane_fit_tolerance)
    gates = torch.tensor([cfg.nn_max_sq_dist, cfg.residual_damping,
                          cfg.min_residual_weight, gate],
                         dtype=torch.float32, device=pose.device)
    return torch.cat([
        R.reshape(-1), pose[3:], M_roll.reshape(-1), M_pitch.reshape(-1),
        M_yaw.reshape(-1), gates,
        torch.zeros(21, dtype=torch.float32, device=pose.device),
    ]).to(torch.float32)


def gn_partials_plain(pts, mask, cand, cand_ok, weight, scalars, mode: str,
                      k: int):
    """The plain PyTorch version of K2: (H (6,6), g (6,), n_valid ())."""
    sc = scalars.tolist()
    gate = sc[_SC_GATES + 3]
    cfg = dataclasses.replace(
        MatchingConfig(), nn_max_sq_dist=sc[_SC_GATES],
        residual_damping=sc[_SC_GATES + 1],
        min_residual_weight=sc[_SC_GATES + 2],
        **({"eigen_ratio_line": gate} if mode == "corner"
           else {"plane_fit_tolerance": gate}))
    R = scalars[0:9].reshape(3, 3)
    pw = pts @ R.T + scalars[9:12]
    d, sel = scan_match._rerank_neighbors(pw, cand, cand_ok, 5)
    near = torch.take_along_dim(cand, sel[..., None], dim=1)
    fit = (scan_match.corner_correspondences if mode == "corner"
           else scan_match.surf_correspondences)
    cc = fit(pw, mask, near, d, cfg, weight)
    M = scalars[_SC_M:_SC_GATES].reshape(3, 3, 3)
    H, g, n_valid = scan_match.normal_equations(M, pts, cc.coeff, cc.residual,
                                                cc.valid)
    return H, g, n_valid.to(torch.float32)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("gn", _FLAGS)
    p, i32 = ctypes.c_void_p, ctypes.c_int
    lib.lis_gn_partials.argtypes = [p, p, p, p, p, p, i32, i32, i32, p, p, p]
    lib.lis_gn_partials.restype = i32
    lib.lis_gn_block_size.argtypes = []
    lib.lis_gn_block_size.restype = i32
    return lib


@functools.cache
def _sym_index(device: torch.device) -> torch.Tensor:
    return torch.tensor(_SYM_INDEX, dtype=torch.int64, device=device)


def _check_inputs(pts, mask, cand, cand_ok, weight, scalars, mode, k):
    q_n = pts.shape[0]
    tensors = (pts, mask, cand, cand_ok, weight, scalars)
    if any(t.device != pts.device for t in tensors):
        raise ValueError("gn_partials: inputs must share a device")
    if any(t.dtype != torch.float32 for t in (pts, cand, weight, scalars)):
        raise TypeError("gn_partials: pts, cand, weight, scalars must be f32")
    if mask.dtype != torch.bool or cand_ok.dtype != torch.bool:
        raise TypeError("gn_partials: mask and cand_ok must be bool")
    if (pts.shape != (q_n, 3) or mask.shape != (q_n,)
            or cand.shape != (q_n, k, 3) or cand_ok.shape != (q_n, k)
            or weight.shape != (q_n,) or scalars.shape != (64,)):
        raise ValueError("gn_partials: expected pts (Q,3), mask (Q,), cand "
                         "(Q,k,3), cand_ok (Q,k), weight (Q,), scalars (64,)")
    if mode not in ("corner", "surf"):
        raise ValueError(f"gn_partials: unknown mode {mode!r}")


def _launch(pts, mask, cand, cand_ok, weight, scalars, mode, k):
    if not all(t.is_contiguous()
               for t in (pts, mask, cand, cand_ok, weight, scalars)):
        raise ValueError("gn_partials: inputs must be contiguous")
    if k not in KERNEL_K:
        raise ValueError(f"gn_partials: kernel is built for k in {KERNEL_K}, "
                         f"got {k}")
    lib = _lib()
    q_n, dev = pts.shape[0], pts.device
    n_blocks = -(-q_n // lib.lis_gn_block_size())
    partials = torch.empty((max(n_blocks, 1), 28), dtype=torch.float32,
                           device=dev)
    out = torch.empty(28, dtype=torch.float32, device=dev)
    err = lib.lis_gn_partials(
        pts.data_ptr(), mask.data_ptr(), cand.data_ptr(), cand_ok.data_ptr(),
        weight.data_ptr(), scalars.data_ptr(), q_n, k,
        1 if mode == "corner" else 0, partials.data_ptr(), out.data_ptr(),
        cuda_build.stream_ptr(dev))
    cuda_build.check(err, "gn kernel")
    gn_partials.launches += 1
    return out[_sym_index(dev)].reshape(6, 6), out[21:27], out[27]


def gn_partials(pts: torch.Tensor, mask: torch.Tensor, cand: torch.Tensor,
                cand_ok: torch.Tensor, weight: torch.Tensor,
                scalars: torch.Tensor, mode: str, k: int):
    """One fused GN accumulation pass over one cloud. Returns (H (6,6),
    g (6,), n_valid () float32). CPU tensors take the plain version; CUDA
    tensors launch kernel K2 (`gn_partials.launches` counts the launches)."""
    _check_inputs(pts, mask, cand, cand_ok, weight, scalars, mode, k)
    if pts.device.type == "cpu":
        return gn_partials_plain(pts, mask, cand, cand_ok, weight, scalars,
                                 mode, k)
    if pts.device.type != "cuda":
        raise ValueError(f"gn_partials: unsupported device {pts.device}")
    return _launch(pts, mask, cand, cand_ok, weight, scalars, mode, k)


gn_partials.launches = 0


def gn_iteration_hg(pose, corner_pts, corner_mask, c_cand, c_ok,
                    surf_pts, surf_mask, s_cand, s_ok,
                    corner_w, surf_w, cfg: MatchingConfig, k: int):
    """The fused H/g build of one GN iteration (corner + surf clouds).
    `pose` may lie on the host; the scalar rows move to the clouds'
    device."""
    dev = corner_pts.device
    ones_c = (torch.ones(corner_pts.shape[0], device=dev)
              if corner_w is None else corner_w)
    ones_s = (torch.ones(surf_pts.shape[0], device=dev)
              if surf_w is None else surf_w)
    Hc, gc, nc = gn_partials(
        corner_pts, corner_mask, c_cand, c_ok, ones_c,
        pack_scalars(pose, cfg, "corner").to(dev), "corner", k)
    Hs, gs, ns = gn_partials(
        surf_pts, surf_mask, s_cand, s_ok, ones_s,
        pack_scalars(pose, cfg, "surf").to(dev), "surf", k)
    return Hc + Hs, gc + gs, (nc + ns).to(torch.int32)
