"""Exact k-NN with neighbor coordinates: kernel K1 and its plain version.

Port of lis_slam_tpu/ops/pallas_knn.py (`knn`, the Pallas TPU kernel
`_knn_kernel`). The kernel is CUDA C++ in csrc/knn.cu — see its header
for what bounds it on the H100 and how its design answers. `knn` takes the
plain PyTorch version (ops/knn.py:knn_bruteforce + a gather) for tensors
on the CPU, and launches the kernel for CUDA tensors; it never falls back.

Contract (as `knn_pallas`): (sq_dists (Q,k) ascending, indices (Q,k)
int32, neighbor xyz (Q,k,3)). With `max_sq_dist`, only neighbors strictly
closer are kept. Unfilled slots hold d=+inf, index -1, xyz 0; ties go to
the lower map index.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import cuda_build
from .knn import knn_bruteforce

KERNEL_K = (1, 5, 8)  # k values csrc/knn.cu instantiates
_FLAGS = ("--fmad=false",)  # products round as in the plain version
_THREADS = 128  # queries per block (csrc/knn.cu kThreads)
_TILE = 1024  # map points per shared-memory tile (kTile)
_TARGET_BLOCKS = 264  # two blocks per SM on a 132-SM H100


def knn_plain(query: torch.Tensor, ref: torch.Tensor,
              ref_mask: torch.Tensor, k: int = 5,
              max_sq_dist: float | None = None):
    """The plain PyTorch version of K1."""
    d, i = knn_bruteforce(query, ref, ref_mask, k=k, max_sq_dist=max_sq_dist)
    near = ref[torch.clamp(i, min=0).to(torch.int64)]
    near = torch.where((i >= 0)[..., None], near, torch.zeros_like(near))
    return d, i, near


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("knn", _FLAGS)
    p, i32 = ctypes.c_void_p, ctypes.c_int
    lib.lis_knn.argtypes = [p, i32, p, p, i32, i32, ctypes.c_float, i32,
                            p, p, p, p, p, p]
    lib.lis_knn.restype = i32
    return lib


def _check_inputs(query, ref, ref_mask):
    dev = query.device
    if ref.device != dev or ref_mask.device != dev:
        raise ValueError("knn: query, ref and ref_mask must share a device")
    if query.dtype != torch.float32 or ref.dtype != torch.float32:
        raise TypeError("knn: query and ref must be float32")
    if ref_mask.dtype != torch.bool:
        raise TypeError("knn: ref_mask must be bool")
    if (query.dim() != 2 or query.shape[1] != 3 or ref.dim() != 2
            or ref.shape[1] != 3 or ref_mask.shape != (ref.shape[0],)):
        raise ValueError("knn: expected query (Q,3), ref (N,3), mask (N,)")


def _launch(query, ref, ref_mask, k, max_sq_dist):
    if not (query.is_contiguous() and ref.is_contiguous()
            and ref_mask.is_contiguous()):
        raise ValueError("knn: inputs must be contiguous")
    if k not in KERNEL_K:
        raise ValueError(f"knn: kernel is built for k in {KERNEL_K}, got {k}")
    q_n, n = query.shape[0], ref.shape[0]
    dev = query.device
    out_d = torch.empty((q_n, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((q_n, k), dtype=torch.int32, device=dev)
    out_xyz = torch.empty((q_n, k, 3), dtype=torch.float32, device=dev)
    if q_n == 0:
        return out_d, out_i, out_xyz
    q_blocks = -(-q_n // _THREADS)
    splits = max(1, min(-(-_TARGET_BLOCKS // q_blocks), -(-n // _TILE)))
    part_d = torch.empty((splits, q_n, k), dtype=torch.float32, device=dev)
    part_i = torch.empty((splits, q_n, k), dtype=torch.int32, device=dev)
    bound = float("inf") if max_sq_dist is None else float(max_sq_dist)
    err = _lib().lis_knn(
        query.data_ptr(), q_n, ref.data_ptr(), ref_mask.data_ptr(), n, k,
        bound, splits, part_d.data_ptr(), part_i.data_ptr(),
        out_d.data_ptr(), out_i.data_ptr(), out_xyz.data_ptr(),
        cuda_build.stream_ptr(dev))
    cuda_build.check(err, "knn kernel")
    knn.launches += 1
    return out_d, out_i, out_xyz


def knn(query: torch.Tensor, ref: torch.Tensor, ref_mask: torch.Tensor,
        k: int = 5, max_sq_dist: float | None = None):
    """Exact k-NN of `query` (Q,3) against the masked map `ref` (N,3).
    CPU tensors take the plain version; CUDA tensors launch kernel K1
    (`knn.launches` counts the launches)."""
    _check_inputs(query, ref, ref_mask)
    if query.device.type == "cpu":
        return knn_plain(query, ref, ref_mask, k=k, max_sq_dist=max_sq_dist)
    if query.device.type != "cuda":
        raise ValueError(f"knn: unsupported device {query.device}")
    return _launch(query, ref, ref_mask, k, max_sq_dist)


knn.launches = 0
