"""The least time of a kernel launch on one H100, from the work its inputs
need: the yardstick of the `<kernel>_roofline` metrics.

Frozen copy of chip_smoke.py:333-407 (`PEAK_*`, `_bound`, `_k1_bound`,
`_gn_flops`, `_k2_bound`), rewritten to import nothing of lis_slam_torch
(K1's squared distance is restated here) and to return only the time.
The counts are of the work, not of any kernel's instructions, so a later
kernel that does the same work faster reads a higher share, and one that
does less than this work reads above 100% (a fault of the count).
"""

from __future__ import annotations

import torch

# published peaks of one H100 SXM at its full 700 W (NVIDIA data sheet):
# HBM3 bandwidth, float32 and float64 outside the tensor cores, dense
# bf16 on the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
PEAK_FP64_FLOPS = 34e12
PEAK_BF16_FLOPS = 989e12


def bound_s(nbytes: float, flops: float, flops64: float = 0.0) -> float:
    """The larger of the bytes moved once at the HBM rate and the
    operations at the float32 (and float64) peaks, in seconds."""
    t_b = nbytes / PEAK_BYTES_S
    t_o = flops / PEAK_FP32_FLOPS + flops64 / PEAK_FP64_FLOPS
    return max(t_b, t_o)


def _pairs_within(q: torch.Tensor, valid: torch.Tensor, cap: float) -> int:
    """Query-map pairs closer than `cap` (squared metres), in blocks."""
    n = 0
    for s in range(0, q.shape[0], 256):
        d = q[s:s + 256, None, :] - valid[None, :, :]
        n += int((torch.sum(d * d, dim=-1) < cap).sum())
    return n


def k1_bound_s(query: torch.Tensor, ref: torch.Tensor, mask: torch.Tensor,
               k: int, cap: float | None) -> float:
    """K1 (exact kNN): each input read once ((Q,3) + (N,3) f32, (N,)
    bool), each output written once ((Q,k) f32 + i32, (Q,k,3) f32); 8
    flops per distance over the pairs within the cap, or every query
    against every valid map point uncapped."""
    q_n, n = query.shape[0], ref.shape[0]
    nbytes = q_n * 12 + n * 13 + q_n * k * 20
    valid = ref[mask]
    if cap is None:
        pairs = q_n * valid.shape[0]
    else:
        pairs = _pairs_within(query.float(), valid.float(), cap)
    return bound_s(nbytes, 8 * pairs)


def gn_flops(k: int) -> int:
    """K2's flops per masked-in query, an estimate from csrc/gn.cu's
    arithmetic (acos, cos, sqrt as 20 each): transform 18, re-rank and
    5-of-k selection 18 k, centroid and covariance 96, eigenvalues ~110,
    eigenvector ~70, line or plane residual and gates ~60, J row ~70, J^T
    J and J^T r terms 27, block sums 28."""
    return 480 + 18 * k


def k2_bound_s(clouds, k: int, lanes: int = 1) -> float:
    """K2 (one GN iteration's H/g build) over `clouds`, (pts, mask,
    weight or None) triples with the lanes' queries flattened: pts, mask,
    candidates (k x 3 f32) and their flags read once per query, the weight
    where one is passed, two 64-float scalar rows and 43 floats out per
    lane; gn_flops per masked-in query."""
    nbytes = lanes * (2 * 64 * 4 + 43 * 4)
    for p, _m, w in clouds:
        n_q = p.reshape(-1, 3).shape[0]
        nbytes += n_q * (12 + 1 + 13 * k + (0 if w is None else 4))
    n_in = sum(int(m.sum()) for _p, m, _w in clouds)
    return bound_s(nbytes, n_in * gn_flops(k))



# K3's operations per lane (chip_smoke.py:3168-3170): the float64
# round-robin Jacobi of the 6x6 H (90 rotations), its float32 Schur solve
# and update, and the float32 scalar rows of the new pose
K3_F64_SOLVE = 90 * (30 + 3 * 12 * 3)
K3_F32_SOLVE = 250 + 36 * 18 + 72 + 12
K3_F32_ROWS = 350


def k3_bound_s(lanes: int, active: int, solves: bool) -> float:
    """K3 (the batched 6x6 GN solve, chip_smoke.py `_k3_bound`): the
    normal equations (43 f32) of the lanes still active, the lane state in
    and out (pose 6 + proj 36 f32, two bools, two int32, two f32) and the
    scalar rows (128 f32) each moved once; per active lane its float64
    and float32 solve, per lane its rows. A rows-only launch
    (`scalar_rows`) reads the state and writes the rows."""
    state = 4 * (6 + 36) + 2 + 4 * 2 + 4 * 2
    if not solves:
        return bound_s(lanes * (state + 128 * 4), lanes * K3_F32_ROWS)
    nbytes = active * 43 * 4 + lanes * (2 * state + 128 * 4)
    return bound_s(nbytes, active * K3_F32_SOLVE + lanes * K3_F32_ROWS,
                   active * K3_F64_SOLVE)
