"""Small-matrix linear algebra, batched (port of lis_slam_tpu/utils/lin.py).

Closed-form 3x3 eigen/plane fits and the 6x6 solve + Jacobi eigh of the
Gauss-Newton normal equations. Same formulas and the same operation order
as the JAX package, so the two agree to float32 rounding.
"""

from __future__ import annotations

import math

import torch


def eigvalsh3(A: torch.Tensor) -> torch.Tensor:
    """Eigenvalues of symmetric (..., 3, 3), ascending (Smith's closed-form
    trigonometric method)."""
    a00, a11, a22 = A[..., 0, 0], A[..., 1, 1], A[..., 2, 2]
    a01, a02, a12 = A[..., 0, 1], A[..., 0, 2], A[..., 1, 2]
    q = (a00 + a11 + a22) / 3.0
    b00, b11, b22 = a00 - q, a11 - q, a22 - q
    p2 = b00 * b00 + b11 * b11 + b22 * b22 + 2.0 * (
        a01 * a01 + a02 * a02 + a12 * a12)
    p = torch.sqrt(torch.clamp(p2 / 6.0, min=1e-30))
    det = (b00 * (b11 * b22 - a12 * a12)
           - a01 * (a01 * b22 - a12 * a02)
           + a02 * (a01 * a12 - b11 * a02))
    r = torch.clamp(det / (2.0 * p * p * p), -1.0, 1.0)
    phi = torch.acos(r) / 3.0
    e_hi = q + 2.0 * p * torch.cos(phi)
    e_lo = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    e_mid = 3.0 * q - e_hi - e_lo
    return torch.stack([e_lo, e_mid, e_hi], dim=-1)


def _projector_eigvec3(A: torch.Tensor, s1: torch.Tensor,
                       s2: torch.Tensor) -> torch.Tensor:
    """Unit eigenvector from the spectral projector (A - s1 I)(A - s2 I):
    its largest-norm column, the FIRST one on ties (jnp.argmax)."""
    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    P = (A - s1[..., None, None] * eye) @ (A - s2[..., None, None] * eye)
    norms = torch.linalg.vector_norm(P, dim=-2)  # column norms (..., 3)
    col = torch.argmax(norms, dim=-1)
    v = torch.take_along_dim(P, col[..., None, None].expand(
        col.shape + (3, 1)), dim=-1)[..., 0]
    n = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    return v / torch.clamp(n, min=1e-20)


def principal_eigvec3(A: torch.Tensor, evals: torch.Tensor) -> torch.Tensor:
    """Unit eigenvector of the LARGEST eigenvalue of symmetric (..., 3, 3)."""
    return _projector_eigvec3(A, evals[..., 1], evals[..., 0])


def smallest_eigvec3(A: torch.Tensor, evals: torch.Tensor) -> torch.Tensor:
    """Unit eigenvector of the SMALLEST eigenvalue of symmetric (..., 3, 3)."""
    return _projector_eigvec3(A, evals[..., 2], evals[..., 1])


def inv3(A: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of (..., 3, 3) via the adjugate."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    A_ = e * i - f * h
    B_ = -(d * i - f * g)
    C_ = d * h - e * g
    det = a * A_ + b * B_ + c * C_
    inv_det = 1.0 / torch.where(torch.abs(det) > 1e-20, det,
                                torch.full_like(det, 1e-20))
    adj = torch.stack([
        torch.stack([A_, -(b * i - c * h), b * f - c * e], dim=-1),
        torch.stack([B_, a * i - c * g, -(a * f - c * d)], dim=-1),
        torch.stack([C_, -(a * h - b * g), a * e - b * d], dim=-1),
    ], dim=-2)
    return adj * inv_det[..., None, None]


def solve6_spd(H: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Solve H x = g for SPD 6x6 via the 3x3-block Schur complement."""
    A, B, C = H[:3, :3], H[:3, 3:], H[3:, 3:]
    g1, g2 = g[:3], g[3:]
    Ai = inv3(A)
    BtAi = B.T @ Ai
    Si = inv3(C - BtAi @ B)
    x2 = Si @ (g2 - BtAi @ g1)
    x1 = Ai @ (g1 - B @ x2)
    return torch.cat([x1, x2])


def solve6_spd_batched(H: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """solve6_spd over leading dims: H (..., 6, 6), g (..., 6). The same
    Schur-complement formulas, as batched matrix products; the plain
    version of the solve in the GN solve kernel K3 (ops/gn_solve.py)."""
    A, B, C = H[..., :3, :3], H[..., :3, 3:], H[..., 3:, 3:]
    g1, g2 = g[..., :3, None], g[..., 3:, None]
    Ai = inv3(A)
    BtAi = B.transpose(-1, -2) @ Ai
    Si = inv3(C - BtAi @ B)
    x2 = Si @ (g2 - BtAi @ g1)
    x1 = Ai @ (g1 - B @ x2)
    return torch.cat([x1, x2], dim=-2)[..., 0]


_PAIRS6 = [(p, q) for p in range(6) for q in range(p + 1, 6)]


def jacobi_eigh6_batched(H: torch.Tensor, sweeps: int = 6
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """jacobi_eigh6 over leading dims as float64 tensor ops: the same
    rotations in the same order on every (6, 6) of H (..., 6, 6), rounded
    to H's dtype. ~1,300 small ops, so a plain version for tests and
    comparisons, not a hot path (kernel K3 runs the round-robin order of
    jacobi_eigh6_rounds on the card)."""
    A = H.detach().double().clone()
    V = torch.eye(6, dtype=A.dtype, device=A.device).expand(A.shape).clone()
    for _ in range(sweeps):
        for p, q in _PAIRS6:
            theta = 0.5 * torch.atan2(2.0 * A[..., p, q],
                                      A[..., p, p] - A[..., q, q] + 1e-30)
            c, s = torch.cos(theta)[..., None], torch.sin(theta)[..., None]
            rp, rq = A[..., p, :].clone(), A[..., q, :].clone()
            A[..., p, :] = c * rp + s * rq
            A[..., q, :] = c * rq - s * rp
            for M in (A, V):
                a, b = M[..., :, p].clone(), M[..., :, q].clone()
                M[..., :, p] = c * a + s * b
                M[..., :, q] = c * b - s * a
    evals = torch.diagonal(A, dim1=-2, dim2=-1).to(H.dtype)
    order = torch.argsort(evals, dim=-1, stable=True)
    vecs = torch.take_along_dim(V.to(H.dtype), order[..., None, :], dim=-1)
    return torch.take_along_dim(evals, order, dim=-1), vecs


# The 15 pairs of a sweep as 5 rounds of 3 disjoint pairs (the circle
# method's round-robin), the order kernel K3 rotates in (csrc/gn_solve.cu)
ROUNDS6 = (((0, 5), (1, 4), (2, 3)), ((0, 4), (3, 5), (1, 2)),
           ((0, 3), (2, 4), (1, 5)), ((0, 2), (1, 3), (4, 5)),
           ((0, 1), (2, 5), (3, 4)))


def givens_half_angle(x: torch.Tensor, y: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos t, sin t) of t = atan2(y, x) / 2, t in (-pi/2, pi/2], without
    a transcendental: r = sqrt(x^2 + y^2), d = r + |x|, q = 1 / sqrt(2 r d);
    for x >= 0, (d q, y q); for x < 0, (|y| q, d q with y's sign), so
    neither branch cancels, and atan2's own branch holds at y = +-0, x < 0
    (+-pi / 2). The formula of kernel K3's rotations (csrc/gn_solve.cu
    half_angle), elementwise on float64 tensors."""
    r = torch.sqrt(x * x + y * y)
    d = r + torch.abs(x)
    q = torch.rsqrt(2.0 * r * d)
    big, small = d * q, y * q
    pos = x >= 0
    c = torch.where(pos, big, torch.abs(small))
    s = torch.where(pos, small, torch.copysign(big, y))
    # r = 0: atan2(+-0, +0) = +-0, atan2(+-0, -0) = +-pi
    neg = torch.signbit(x)
    zero = r == 0
    c = torch.where(zero, (~neg).to(x.dtype), c)
    s = torch.where(zero, torch.where(neg, torch.copysign(torch.ones_like(y),
                                                          y), y), s)
    return c, s


def _rotate_host(A: list, V: list, p: int, q: int, c: float, s: float):
    """One Jacobi rotation of the pair (p, q) on nested lists, in place:
    rows p, q of A, then columns p, q of A, then columns p, q of V."""
    rp, rq = A[p], A[q]
    A[p] = [c * a + s * b for a, b in zip(rp, rq)]
    A[q] = [c * b - s * a for a, b in zip(rp, rq)]
    for M in (A, V):
        for row in M:
            a, b = row[p], row[q]
            row[p], row[q] = c * a + s * b, c * b - s * a


def _jacobi_host(H: torch.Tensor, rounds, sweeps: int):
    """Jacobi rotations of one symmetric 6x6 on the host in float64, the
    pairs of each round in turn (a round: one or more pairs), each with
    the angle 0.5 atan2(2 a_pq, a_pp - a_qq + 1e-30); rounded to H's
    dtype, the eigenvalues ascending (stable) and V's columns in their
    order, on H's device."""
    A = H.detach().cpu().double().tolist()
    V = [[1.0 if i == j else 0.0 for j in range(6)] for i in range(6)]
    for _ in range(sweeps):
        for rnd in rounds:
            for p, q in rnd:
                theta = 0.5 * math.atan2(2.0 * A[p][q],
                                         A[p][p] - A[q][q] + 1e-30)
                _rotate_host(A, V, p, q, math.cos(theta), math.sin(theta))
    evals = torch.tensor([A[i][i] for i in range(6)], dtype=H.dtype)
    order = torch.argsort(evals, stable=True)
    vecs = torch.tensor(V, dtype=H.dtype)[:, order]
    return evals[order].to(H.device), vecs.to(H.device)


def jacobi_eigh6_rounds(H: torch.Tensor, sweeps: int = 6
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """jacobi_eigh6 in kernel K3's order: each sweep's 15 pairs as the 5
    rounds of ROUNDS6, a round's three rotations applied one after the
    other in its order (disjoint pairs: none changes another's angle, so
    the kernel rotates the three at once). The plain version of K3's
    eigendecomposition (ops/gn_solve.py:solve_plain); the angle from
    atan2 as the JAX package takes it, which K3's half-angle (c, s)
    (givens_half_angle) reproduces."""
    return _jacobi_host(H, ROUNDS6, sweeps)


def jacobi_eigh6(H: torch.Tensor, sweeps: int = 6
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Eigendecomposition of one symmetric 6x6 by cyclic Jacobi rotations,
    in the JAX package's pair order (rows p,q then columns p,q of A, then
    columns p,q of V). Returns (eigenvalues ascending, eigenvectors as
    columns) on H's device.

    The 36 entries are rotated as Python floats on the host: the 90
    rotations are ~1,300 scalar updates, which as tensor ops cost ~16 ms of
    per-op overhead on a CPU and more as CUDA launches, against ~0.5 ms
    here. Double precision makes the result at least as accurate as the
    float32 JAX version; it is rounded to H's dtype on return."""
    return _jacobi_host(H, [[pq] for pq in _PAIRS6], sweeps)


def solve_plane_lsq(pts5: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Total-least-squares plane n.x + d = 0 through (..., k, 3) points:
    n = smallest-eigenvalue direction of the point scatter, d = -n.centroid.
    Returns (unit normal (..., 3), offset (...,))."""
    c = torch.mean(pts5, dim=-2)
    diff = pts5 - c[..., None, :]
    cov = torch.einsum("...ki,...kj->...ij", diff, diff)
    n = smallest_eigvec3(cov, eigvalsh3(cov))
    return n, -torch.einsum("...i,...i->...", n, c)
