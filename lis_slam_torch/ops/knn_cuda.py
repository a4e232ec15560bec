"""Exact k-NN with neighbor coordinates: kernel K1 and its plain version.

Port of lis_slam_tpu/ops/pallas_knn.py (`knn`, the Pallas TPU kernel
`_knn_kernel`). The kernel is CUDA C++ in csrc/knn.cu — see its header
for what bounds it on the H100 and how its design answers: per-tile AABBs
of the morton-ordered map, and a group of 32 queries scans only the tiles
whose box can still beat its worst k-th best. `knn` takes the plain
PyTorch version (ops/knn.py:knn_bruteforce + a gather) for tensors on the
CPU, and launches the kernel for CUDA tensors; it never falls back.
`knn_lanes` searches B query clouds against B maps (the scheduled
solver's lanes) in the same two launches; each lane's result is bit-equal
to a one-lane launch and to the plain version, which loops over the
lanes on the CPU.
`tile_aabb_plain` and `tile_lower_bound` are the plain versions of the
kernel's tile boxes and of its skip test, for the CPU tests.

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
_GROUP = 32  # queries per block (one per lane; csrc/knn.cu)


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
    lib.lis_knn.argtypes = [p, i32, p, p, i32, i32, i32, ctypes.c_float, p,
                            p, p, p, p, p, p]
    lib.lis_knn.restype = i32
    for fn in (lib.lis_knn_tile, lib.lis_knn_warps):
        fn.argtypes = []
        fn.restype = i32
    return lib


def tile_aabb_plain(ref: torch.Tensor, ref_mask: torch.Tensor, tile: int):
    """The plain version of the kernel's prepass: per tile of `tile` map
    points, the (lo, hi) corners (T, 3) of its masked-in points; a tile
    with none gets lo = +inf, hi = -inf."""
    n = ref.shape[0]
    n_tiles = -(-n // tile)
    pad = n_tiles * tile - n
    r = torch.cat([ref, ref.new_zeros((pad, 3))]).reshape(n_tiles, tile, 3)
    m = torch.cat([ref_mask, ref_mask.new_zeros(pad)]).reshape(
        n_tiles, tile, 1)
    inf = torch.tensor(float("inf"), dtype=ref.dtype, device=ref.device)
    return (torch.where(m, r, inf).amin(dim=1),
            torch.where(m, r, -inf).amax(dim=1))


def tile_lower_bound(q_lo, q_hi, t_lo, t_hi):
    """The kernel's skip test in float32, in its order: a lower bound of
    every squared distance between a point of the query box (q_lo, q_hi)
    and a point of the tile box (t_lo, t_hi), (..., 3) corners each."""
    zero = torch.zeros((), dtype=q_lo.dtype, device=q_lo.device)
    gap = torch.maximum(torch.maximum(t_lo - q_hi, q_lo - t_hi), zero)
    gx, gy, gz = gap.unbind(-1)
    return gx * gx + gy * gy + gz * gz


def _check_inputs(query, ref, ref_mask, lanes: bool = False):
    dev = query.device
    if ref.device != dev or ref_mask.device != dev:
        raise ValueError("knn: query, ref and ref_mask must share a device")
    if query.dtype != torch.float32 or ref.dtype != torch.float32:
        raise TypeError("knn: query and ref must be float32")
    if ref_mask.dtype != torch.bool:
        raise TypeError("knn: ref_mask must be bool")
    lead = query.shape[:1] if lanes else ()
    d = len(lead)
    if (query.dim() != 2 + d or query.shape[-1] != 3
            or ref.dim() != 2 + d or ref.shape[-1] != 3
            or ref.shape[:d] != lead or ref_mask.shape != ref.shape[:-1]):
        raise ValueError("knn: expected query (Q,3), ref (N,3), mask (N,)"
                         + (" with a leading lane dim B" if lanes else ""))


def _launch(query, ref, ref_mask, k, max_sq_dist, tiles_done=None):
    """Launch K1 over (B, Q, 3) queries and (B, N, 3) maps. `tiles_done`
    (an int32 tensor of B x groups x warps, filled with each warp's count
    of scanned tiles) serves tiles_computed; the main path passes none."""
    if not (query.is_contiguous() and ref.is_contiguous()
            and ref_mask.is_contiguous()):
        raise ValueError("knn: inputs must be contiguous")
    if k not in KERNEL_K:
        raise ValueError(f"knn: kernel is built for k in {KERNEL_K}, got {k}")
    lib = _lib()
    lanes, q_n, n = query.shape[0], query.shape[1], ref.shape[1]
    dev = query.device
    out_d = torch.empty((lanes, q_n, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((lanes, q_n, k), dtype=torch.int32, device=dev)
    out_xyz = torch.empty((lanes, q_n, k, 3), dtype=torch.float32,
                          device=dev)
    if q_n == 0 or lanes == 0:
        return out_d, out_i, out_xyz
    tile = lib.lis_knn_tile()
    n_tiles = -(-n // tile)
    packed = torch.empty((lanes, n_tiles * tile, 4), dtype=torch.float32,
                         device=dev)
    boxes = torch.empty((lanes, 2 * n_tiles, 4), dtype=torch.float32,
                        device=dev)
    bound = float("inf") if max_sq_dist is None else float(max_sq_dist)
    err = lib.lis_knn(
        query.data_ptr(), q_n, ref.data_ptr(), ref_mask.data_ptr(), n,
        lanes, k, bound, packed.data_ptr(), boxes.data_ptr(),
        out_d.data_ptr(), out_i.data_ptr(), out_xyz.data_ptr(),
        None if tiles_done is None else tiles_done.data_ptr(),
        cuda_build.stream_ptr(dev))
    cuda_build.check(err, "knn kernel")
    knn.launches += 1
    return out_d, out_i, out_xyz


def tiles_computed(query, ref, ref_mask, k=5, max_sq_dist=None):
    """(tiles scanned, tiles a brute-force scan would take) of one K1
    launch on CUDA tensors, summed over its query groups (and lanes, for
    (B, Q, 3) queries against (B, N, 3) maps): the share of the map that
    skipping leaves out is 1 - scanned / total."""
    lanes = query.dim() == 3
    _check_inputs(query, ref, ref_mask, lanes)
    if not lanes:
        query, ref, ref_mask = query[None], ref[None], ref_mask[None]
    lib = _lib()
    b, q_n, n = query.shape[0], query.shape[1], ref.shape[1]
    groups, n_tiles = -(-q_n // _GROUP), -(-n // lib.lis_knn_tile())
    done = torch.zeros(b * groups * lib.lis_knn_warps(), dtype=torch.int32,
                       device=query.device)
    _launch(query, ref, ref_mask, k, max_sq_dist, tiles_done=done)
    return int(done.sum()), b * groups * n_tiles


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
    return tuple(t[0] for t in _launch(query[None], ref[None], ref_mask[None],
                                       k, max_sq_dist))


knn.launches = 0


def knn_lanes_plain(query, ref, ref_mask, k=5, max_sq_dist=None):
    """The plain version of K1 over lanes: knn_plain on each lane,
    stacked (knn_bruteforce's nonzero has no batched form)."""
    outs = [knn_plain(q, r, m, k=k, max_sq_dist=max_sq_dist)
            for q, r, m in zip(query, ref, ref_mask)]
    return tuple(torch.stack(t) for t in zip(*outs))


def knn_lanes(query: torch.Tensor, ref: torch.Tensor, ref_mask: torch.Tensor,
              k: int = 5, max_sq_dist: float | None = None):
    """Exact k-NN per lane: queries (B, Q, 3) against masked maps (B, N, 3),
    (B, N). Returns (B, Q, k) distances and indices (into each lane's own
    map) and (B, Q, k, 3) neighbours. CPU tensors take the plain version;
    CUDA tensors launch K1 once for every lane (counted in
    `knn.launches`)."""
    _check_inputs(query, ref, ref_mask, lanes=True)
    if query.device.type == "cpu":
        return knn_lanes_plain(query, ref, ref_mask, k, max_sq_dist)
    if query.device.type != "cuda":
        raise ValueError(f"knn: unsupported device {query.device}")
    return _launch(query, ref, ref_mask, k, max_sq_dist)
