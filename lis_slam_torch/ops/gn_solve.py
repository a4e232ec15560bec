"""The Gauss-Newton solve of the solvers on the card: kernel K3 and its
plain version. The scheduled solver launches it over lanes, scan_to_map
over one lane when its clouds are on CUDA under the "pallas" backend.

Port of the XLA code that follows each GN iteration's H/g build in
lis_slam_tpu/ops/scan_match.py: `gn_solve_from_hg` (:181-214, the 6x6
Schur solve, the Jacobi eigendecomposition, the degeneracy projection,
the `enough` and convergence tests) and the masked state update of
`scan_to_map_scheduled` (:456-466, a converged lane stays frozen and `it`
counts only active iterations). No Pallas kernel: the JAX package leaves
this to XLA. Here it is one launch per GN iteration for every lane: the
kernel is CUDA C++ in csrc/gn_solve.cu (see its header for what bounds it
and how its design answers), because the 90 Jacobi rotations as tensor
ops cost ~1,300 launches (utils/lin.py:jacobi_eigh6_batched). K3 rotates
the Jacobi pairs in round-robin rounds of three disjoint pairs, so its
plain version does too (utils/lin.py:jacobi_eigh6_rounds): the same
eigenvalues as the JAX package's cyclic order, to float32 rounding
(tests/test_torch_gn_solve.py).

K3 also writes each lane's next (2, 64) scalar rows for kernel K2 (the
layout of gn_cuda.pack_scalars: rotation, translation, the three rotation
Jacobians and the gates) to device memory, so the next H/g build needs no
copy from the host. `scalar_rows` makes the first iteration's rows (the
same kernel with the solve skipped).

The wrappers take the plain version for tensors on the CPU and launch the
kernel for CUDA tensors; they never fall back. Every K3 launch counts in
`solve.launches`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..config import MatchingConfig
from ..utils import lin, se3
from . import cuda_build, scan_match

_FLAGS = ("--fmad=false",)  # products round as the plain version's do

# the lane state K3 reads and writes, in GNState's field order
_STATE = (("pose", torch.float32, (6,)), ("proj", torch.float32, (6, 6)),
          ("degenerate", torch.bool, ()), ("converged", torch.bool, ()),
          ("n_valid", torch.int32, ()), ("it", torch.int32, ()),
          ("delta_r", torch.float32, ()), ("delta_t", torch.float32, ()))


def init_state(pose0: torch.Tensor) -> scan_match.GNState:
    """The scheduled solver's start for poses (B, 6): identity projection,
    flags false, counts and deltas zero, all on pose0's device."""
    b, dev = pose0.shape[0], pose0.device
    zeros = functools.partial(torch.zeros, b, device=dev)
    return scan_match.GNState(
        pose=pose0.to(torch.float32).contiguous(),
        # repeat copies for any b (an expanded eye is contiguous at b = 1
        # only, so .contiguous() would launch a copy for b > 1 alone)
        proj=torch.eye(6, device=dev).repeat(b, 1, 1),
        degenerate=zeros(dtype=torch.bool), converged=zeros(dtype=torch.bool),
        n_valid=zeros(dtype=torch.int32), it=zeros(dtype=torch.int32),
        delta_r=zeros(dtype=torch.float32), delta_t=zeros(dtype=torch.float32))


def scalar_rows_plain(pose: torch.Tensor, cfg: MatchingConfig
                      ) -> torch.Tensor:
    """(B, 2, 64) float32: gn_cuda.pack_scalars' corner row, then its surf
    row, for each lane's pose (B, 6), on pose's device."""
    b = pose.shape[0]
    R = se3.euler_to_rot(pose[:, :3])
    mats = scan_match._rotation_jacobian_mats(pose[:, :3])
    gates = [cfg.nn_max_sq_dist, cfg.residual_damping,
             cfg.min_residual_weight]
    rows = []
    for last in (cfg.eigen_ratio_line, cfg.plane_fit_tolerance):
        fill = torch.zeros((b, 25), dtype=torch.float32, device=pose.device)
        for i, v in enumerate(gates + [last]):
            fill[:, i] = v
        rows.append(torch.cat([R.reshape(b, 9), pose[:, 3:]]
                              + [m.reshape(b, 9) for m in mats] + [fill],
                              dim=1))
    return torch.stack(rows, dim=1).to(torch.float32)


def solve_plain(hg: torch.Tensor, st: scan_match.GNState,
                cfg: MatchingConfig):
    """The plain version of K3: per lane, scan_match.gn_solve_from_hg on
    the packed normal equations hg (B, 43) = [H (6x6 row-major), g (6),
    n_valid] with K3's Jacobi order (lin.jacobi_eigh6_rounds), then the
    scheduled loop's masked update. Returns (next GNState, its (B, 2, 64)
    scalar rows), on hg's device."""
    dev = hg.device
    hg_h = hg.detach().cpu()
    old = [getattr(st, f).detach().cpu() for f, _t, _s in _STATE]
    new = [t.clone() for t in old]
    for b in range(hg.shape[0]):
        if bool(old[3][b]):  # converged: frozen
            continue
        pose, proj, degen, conv, n_valid, d_r, d_t = (
            scan_match.gn_solve_from_hg(
                old[0][b], hg_h[b, :36].reshape(6, 6), hg_h[b, 36:42],
                int(hg_h[b, 42]), cfg, eigh=lin.jacobi_eigh6_rounds))
        for i, v in enumerate((pose, proj, degen, conv, n_valid,
                               int(old[5][b]) + 1, d_r, d_t)):
            new[i][b] = v
    out = scan_match.GNState(*(t.to(dev) for t in new))
    return out, scalar_rows_plain(out.pose, cfg)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("gn_solve", _FLAGS)
    p, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.lis_gn_solve.argtypes = ([p] + [p] * 8 + [p] * 8 + [p, i32, i32]
                                 + [f32, i32, f32, f32] + [f32] * 5 + [p])
    lib.lis_gn_solve.restype = i32
    return lib


def _check_state(st: scan_match.GNState, b: int, dev) -> None:
    for (name, dtype, shape), t in zip(_STATE, st):
        if (t.dtype != dtype or t.shape != (b,) + shape or t.device != dev
                or not t.is_contiguous()):
            raise ValueError(f"gn_solve: state field {name} must be "
                             f"{dtype} {(b,) + shape}, contiguous, on {dev}")


def _outputs(st: scan_match.GNState):
    """The next state and its (B, 2, 64) scalar rows, uninitialised, on
    st's device (the kernel reads st and writes these)."""
    out = scan_match.GNState(*(torch.empty_like(t) for t in st))
    rows = torch.empty((st.pose.shape[0], 2, 64), dtype=torch.float32,
                       device=st.pose.device)
    return out, rows


def _launch(hg, st: scan_match.GNState, cfg: MatchingConfig,
            do_solve: bool):
    b, dev = st.pose.shape[0], st.pose.device
    _check_state(st, b, dev)
    if hg is not None and (hg.dtype != torch.float32 or hg.shape != (b, 43)
                           or hg.device != dev or not hg.is_contiguous()):
        raise ValueError("gn_solve: hg must be float32 (B, 43), contiguous, "
                         "on the state's device")
    out, rows = _outputs(st)
    err = _lib().lis_gn_solve(
        None if hg is None else hg.data_ptr(),
        *(t.data_ptr() for t in st), *(t.data_ptr() for t in out),
        rows.data_ptr(), b, int(do_solve),
        cfg.degeneracy_eigen_threshold, cfg.min_valid_points,
        cfg.converge_delta_r_deg, cfg.converge_delta_t_cm,
        cfg.nn_max_sq_dist, cfg.residual_damping, cfg.min_residual_weight,
        cfg.eigen_ratio_line, cfg.plane_fit_tolerance,
        cuda_build.stream_ptr(dev))
    cuda_build.check(err, "gn_solve kernel")
    solve.launches += 1
    return out, rows


def _device(t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"gn_solve: unsupported device {t.device}")
    return t.device.type


def solve(hg: torch.Tensor, st: scan_match.GNState, cfg: MatchingConfig):
    """One GN solve and masked update for every lane: hg (B, 43) packed
    normal equations, st the lanes' GNState (B-leading tensors). Returns
    (next GNState, its (B, 2, 64) scalar rows). CPU tensors take the plain
    version; CUDA tensors launch K3 once."""
    if _device(hg) == "cpu":
        return solve_plain(hg, st, cfg)
    return _launch(hg, st, cfg, do_solve=True)


solve.launches = 0


def scalar_rows(st: scan_match.GNState, cfg: MatchingConfig) -> torch.Tensor:
    """The (B, 2, 64) scalar rows of the lanes' current poses: K3 with the
    solve skipped on CUDA (one launch, counted), the plain version on the
    CPU."""
    if _device(st.pose) == "cpu":
        return scalar_rows_plain(st.pose, cfg)
    return _launch(None, st, cfg, do_solve=False)[1]
