"""Fused Gauss-Newton accumulation: kernel K2 and its plain version.

Port of lis_slam_tpu/ops/pallas_gn.py (`gn_partials`, the Pallas TPU
kernel `_gn_kernel`, `pack_scalars`, `gn_iteration_hg`). The kernel is CUDA
C++ in csrc/gn.cu — see its header for what bounds it on the H100 and how
its design answers: one launch per GN iteration for both clouds (and
every lane), the scalar rows by value from the host or from device
memory, each lane's block sums reduced by its last block. The wrappers
take the plain PyTorch version for tensors on the CPU and launch the
kernel for CUDA tensors; they never fall back.

`gn_iteration_vec` is the main path's call (scan_match, once per GN
iteration): it returns the packed (43,) normal equations [H (6x6
row-major), g (6), n_valid], so the solver brings them to the host in one
copy. `gn_iteration_hg` unpacks them as the JAX function returns them;
`gn_partials` runs one cloud. `gn_iteration_lanes` is the scheduled
solver's call: B lanes in one launch, each lane's scalar rows read from
device memory (where kernel K3 wrote them), (B, 43) out; each lane's
result is bit-equal to a one-lane launch on its inputs. It computes each
row and the sums in float64 and rounds H, g once: on the circuit,
float32 rounding of the rows whose five neighbours are nearly collinear
moves the weakest eigenvalue of H by 5-9%, and where that eigenvalue
sits at the degeneracy threshold the solver's projection, and with it
the lane's drift, followed the rounding (PERF.md, section 6). The one-lane
calls keep float32, as the JAX kernel computes, and so does the lanes
call on the CPU, where the tests hold the port to the JAX package;
`gn_iteration_lanes_plain` is its plain version in either precision.
Every K2 launch counts in `gn_iteration_vec.launches`.

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
    cloud = [p, p, p, p, p, i32]
    lib.lis_gn_iteration.argtypes = cloud + cloud + [i32, p, p, i32, i32, p,
                                                      p, p, p]
    lib.lis_gn_iteration.restype = i32
    lib.lis_gn_block_size.argtypes = []
    lib.lis_gn_block_size.restype = i32
    return lib


_TICKETS: dict = {}


def _tickets(device: torch.device, lanes: int) -> torch.Tensor:
    """Zeroed counters, one per lane, that the last block of each lane of
    a launch on `device` claims and resets (launches on one stream run one
    after another). Grown, once, for more lanes."""
    t = _TICKETS.get(device)
    if t is None or t.shape[0] < lanes:
        t = _TICKETS[device] = torch.zeros(max(lanes, 8), dtype=torch.int32,
                                           device=device)
    return t


def _check_cloud(pts, mask, cand, cand_ok, weight, k, what, lead=()):
    q_n = pts.shape[len(lead)] if pts.dim() > len(lead) else -1
    tensors = [t for t in (pts, mask, cand, cand_ok, weight) if t is not None]
    if any(t.device != pts.device for t in tensors):
        raise ValueError(f"{what}: inputs must share a device")
    if any(t is not None and t.dtype != torch.float32
           for t in (pts, cand, weight)):
        raise TypeError(f"{what}: pts, cand, weight, scalars must be f32")
    if mask.dtype != torch.bool or cand_ok.dtype != torch.bool:
        raise TypeError(f"{what}: mask and cand_ok must be bool")
    if (pts.shape != lead + (q_n, 3) or mask.shape != lead + (q_n,)
            or cand.shape != lead + (q_n, k, 3)
            or cand_ok.shape != lead + (q_n, k)
            or (weight is not None and weight.shape != lead + (q_n,))):
        raise ValueError(f"{what}: expected pts (Q,3), mask (Q,), cand "
                         "(Q,k,3), cand_ok (Q,k), weight (Q,), scalars (64,)"
                         + (" with a leading lane dim" if lead else ""))


def _check_inputs(pts, mask, cand, cand_ok, weight, scalars, mode, k):
    _check_cloud(pts, mask, cand, cand_ok, weight, k, "gn_partials")
    if scalars.device != pts.device:
        raise ValueError("gn_partials: inputs must share a device")
    if scalars.dtype != torch.float32:
        raise TypeError("gn_partials: pts, cand, weight, scalars must be f32")
    if scalars.shape != (64,):
        raise ValueError("gn_partials: expected pts (Q,3), mask (Q,), cand "
                         "(Q,k,3), cand_ok (Q,k), weight (Q,), scalars (64,)")
    if mode not in ("corner", "surf"):
        raise ValueError(f"gn_partials: unknown mode {mode!r}")


def _launch(corner, surf, rows: torch.Tensor, k: int, lanes: int = 0):
    """One K2 launch over the clouds `corner` and `surf`, each None or
    (pts, mask, cand, cand_ok, weight or None) on one CUDA device. One
    lane (lanes=0): clouds (Q, ...), `rows` the (2, 64) float32 scalar
    rows on the host, passed by value; returns the packed (43,) result.
    B lanes: clouds (B, Q, ...), `rows` (B, 2, 64) on the device, rows
    and sums in float64; returns (B, 43)."""
    if k not in KERNEL_K:
        raise ValueError(f"gn_partials: kernel is built for k in {KERNEL_K}, "
                         f"got {k}")
    lib = _lib()
    dev = (corner if corner is not None else surf)[0].device
    q_axis = 1 if lanes else 0
    args, n_blocks = [], 0
    for c in (corner, surf):
        if c is None:
            args += [None] * 5 + [0]
            continue
        if not all(t.is_contiguous() for t in c if t is not None):
            raise ValueError("gn_partials: inputs must be contiguous")
        args += [None if t is None else t.data_ptr() for t in c]
        args.append(c[0].shape[q_axis])
        n_blocks += -(-c[0].shape[q_axis] // lib.lis_gn_block_size())
    if lanes:
        if (rows.dtype != torch.float32 or rows.shape != (lanes, 2, 64)
                or rows.device != dev or not rows.is_contiguous()):
            raise ValueError("gn_iteration_lanes: rows must be float32 "
                             "(B, 2, 64), contiguous, on the clouds' device")
        host, dev_rows = None, rows.data_ptr()
    else:
        rows = rows.to(torch.float32).contiguous()
        host, dev_rows = rows.data_ptr(), None
    n_lanes = max(lanes, 1)
    partials = torch.empty((n_lanes * max(n_blocks, 1), 28),
                           dtype=torch.float64 if lanes else torch.float32,
                           device=dev)
    out = torch.empty((n_lanes, 43) if lanes else (43,), dtype=torch.float32,
                      device=dev)
    err = lib.lis_gn_iteration(
        *args, k, host, dev_rows, n_lanes, int(bool(lanes)),
        partials.data_ptr(),
        _tickets(dev, n_lanes).data_ptr(), out.data_ptr(),
        cuda_build.stream_ptr(dev))
    cuda_build.check(err, "gn kernel")
    gn_iteration_vec.launches += 1
    return out


def _unpack(hg: torch.Tensor):
    return hg[:36].reshape(6, 6), hg[36:42], hg[42]


def gn_partials(pts: torch.Tensor, mask: torch.Tensor, cand: torch.Tensor,
                cand_ok: torch.Tensor, weight: torch.Tensor,
                scalars: torch.Tensor, mode: str, k: int):
    """One fused GN accumulation pass over one cloud. Returns (H (6,6),
    g (6,), n_valid () float32). CPU tensors take the plain version; CUDA
    tensors launch kernel K2 (its scalar row is read back to the host)."""
    _check_inputs(pts, mask, cand, cand_ok, weight, scalars, mode, k)
    if pts.device.type == "cpu":
        return gn_partials_plain(pts, mask, cand, cand_ok, weight, scalars,
                                 mode, k)
    if pts.device.type != "cuda":
        raise ValueError(f"gn_partials: unsupported device {pts.device}")
    cloud = (pts, mask, cand, cand_ok, weight)
    row = scalars.detach().cpu()
    return _unpack(_launch(cloud if mode == "corner" else None,
                           cloud if mode == "surf" else None,
                           torch.stack([row, row]), k))


def scalar_rows(pose: torch.Tensor, cfg: MatchingConfig) -> torch.Tensor:
    """(2, 64) float32 on the host: pack_scalars' corner row, then its surf
    row (the same but for the gate in slot 42)."""
    corner = pack_scalars(pose.detach().to("cpu", torch.float32), cfg,
                          "corner")
    rows = torch.stack([corner, corner])
    rows[1, _SC_GATES + 3] = cfg.plane_fit_tolerance
    return rows


def gn_iteration_vec(pose, corner_pts, corner_mask, c_cand, c_ok,
                     surf_pts, surf_mask, s_cand, s_ok,
                     corner_w, surf_w, cfg: MatchingConfig, k: int):
    """The fused H/g build of one GN iteration (corner + surf clouds), as
    the packed (43,) float32 [H (6x6 row-major), g (6), n_valid] on the
    clouds' device. `pose` may lie on the host (the main path keeps it
    there). CUDA clouds: one K2 launch, no host-to-device copy; CPU
    clouds: the plain version per cloud, summed."""
    dev = corner_pts.device
    _check_cloud(corner_pts, corner_mask, c_cand, c_ok, corner_w, k,
                 "gn_iteration")
    _check_cloud(surf_pts, surf_mask, s_cand, s_ok, surf_w, k,
                 "gn_iteration")
    if surf_pts.device != dev:
        raise ValueError("gn_iteration: clouds must share a device")
    if dev.type == "cuda":
        return _launch((corner_pts, corner_mask, c_cand, c_ok, corner_w),
                       (surf_pts, surf_mask, s_cand, s_ok, surf_w),
                       scalar_rows(pose, cfg), k)
    if dev.type != "cpu":
        raise ValueError(f"gn_iteration: unsupported device {dev}")
    outs = []
    for mode, pts, mask, cand, ok, w in (
            ("corner", corner_pts, corner_mask, c_cand, c_ok, corner_w),
            ("surf", surf_pts, surf_mask, s_cand, s_ok, surf_w)):
        w = torch.ones(pts.shape[0], device=dev) if w is None else w
        outs.append(gn_partials_plain(
            pts, mask, cand, ok, w, pack_scalars(pose, cfg, mode).to(dev),
            mode, k))
    (Hc, gc, nc), (Hs, gs, ns) = outs
    return torch.cat([(Hc + Hs).reshape(-1), gc + gs, (nc + ns).reshape(1)])


gn_iteration_vec.launches = 0


def gn_iteration_lanes(rows: torch.Tensor, corner_pts, corner_mask, c_cand,
                       c_ok, surf_pts, surf_mask, s_cand, s_ok, corner_w,
                       surf_w, k: int) -> torch.Tensor:
    """The fused H/g build of one GN iteration for B lanes: clouds with a
    leading lane dim ((B, Q, 3) points, (B, Q, k, 3) candidates, ...),
    `rows` the lanes' (B, 2, 64) scalar rows (gn_solve writes them on the
    device). Returns the packed (B, 43) float32 normal equations. CUDA: one
    K2 launch for every lane, rows and sums in float64; CPU: the plain
    version in float32 (gn_iteration_lanes_plain), as the JAX package."""
    lead = rows.shape[:1]
    for c in ((corner_pts, corner_mask, c_cand, c_ok, corner_w),
              (surf_pts, surf_mask, s_cand, s_ok, surf_w)):
        _check_cloud(*c, k, "gn_iteration_lanes", lead)
        if c[0].device != rows.device:
            raise ValueError("gn_iteration_lanes: inputs must share a device")
    dev = rows.device
    if dev.type == "cuda":
        return _launch((corner_pts, corner_mask, c_cand, c_ok, corner_w),
                       (surf_pts, surf_mask, s_cand, s_ok, surf_w),
                       rows, k, lanes=lead[0])
    if dev.type != "cpu":
        raise ValueError(f"gn_iteration_lanes: unsupported device {dev}")
    return gn_iteration_lanes_plain(rows, corner_pts, corner_mask, c_cand,
                                    c_ok, surf_pts, surf_mask, s_cand, s_ok,
                                    corner_w, surf_w, k, torch.float32)


def gn_iteration_lanes_plain(rows, corner_pts, corner_mask, c_cand, c_ok,
                             surf_pts, surf_mask, s_cand, s_ok, corner_w,
                             surf_w, k: int,
                             dtype: torch.dtype = torch.float64
                             ) -> torch.Tensor:
    """The plain version of gn_iteration_lanes: per lane, gn_partials_plain
    of each cloud on its inputs cast to `dtype` (float64: the kernel's
    precision), summed, rounded to float32 (B, 43), on the clouds'
    device."""
    out = []
    for b in range(rows.shape[0]):
        sums = []
        for i, (mode, pts, mask, cand, ok, w) in enumerate((
                ("corner", corner_pts, corner_mask, c_cand, c_ok, corner_w),
                ("surf", surf_pts, surf_mask, s_cand, s_ok, surf_w))):
            wb = (torch.ones(pts.shape[1], dtype=dtype, device=pts.device)
                  if w is None else w[b].to(dtype))
            sums.append(gn_partials_plain(
                pts[b].to(dtype), mask[b], cand[b].to(dtype), ok[b], wb,
                rows[b, i].to(dtype), mode, k))
        (Hc, gc, nc), (Hs, gs, ns) = sums
        out.append(torch.cat([(Hc + Hs).reshape(-1), gc + gs,
                              (nc + ns).reshape(1).to(dtype)]))
    return torch.stack(out).to(torch.float32)


def gn_iteration_hg(pose, corner_pts, corner_mask, c_cand, c_ok,
                    surf_pts, surf_mask, s_cand, s_ok,
                    corner_w, surf_w, cfg: MatchingConfig, k: int):
    """gn_iteration_vec unpacked as the JAX function returns it: (H (6,6),
    g (6,), n_valid () int32)."""
    H, g, n = _unpack(gn_iteration_vec(
        pose, corner_pts, corner_mask, c_cand, c_ok, surf_pts, surf_mask,
        s_cand, s_ok, corner_w, surf_w, cfg, k))
    return H, g, n.to(torch.int32)
