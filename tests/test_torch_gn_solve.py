"""Kernel K3's host algorithms against the JAX package, on the CPU: the
port's host Jacobi (lin.jacobi_eigh6, the JAX pair order) and K3's order
(lin.jacobi_eigh6_rounds, the plain version of the kernel's
eigendecomposition) against lis_slam_tpu.utils.lin.jacobi_eigh6
(float32); the half-angle (c, s) of K3's rotations
(lin.givens_half_angle) against cos / sin of the atan2 angle at every
rotation of those matrices; and K3's plain version
(ops/gn_solve.solve_plain) against the JAX package's gn_solve_from_hg,
lane by lane. Matrices from numpy with a seed: random SPD, rank-deficient
(eigenvalues at 0 and either side of the degeneracy threshold 100),
repeated eigenvalues, diagonal with a_pp < a_qq (the pi/2 swap) and a
negative zero off the diagonal. The JAX functions run eagerly (no
compile)."""

import math

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp
import torch

from lis_slam_tpu.config import MatchingConfig as JMatchingConfig
from lis_slam_tpu.ops import scan_match as jsm
from lis_slam_tpu.utils import lin as jlin
from lis_slam_torch.config import MatchingConfig
from lis_slam_torch.ops import gn_solve
from lis_slam_torch.utils import lin

THRESHOLD = MatchingConfig().degeneracy_eigen_threshold  # 100
# JAX's Jacobi is float32: 90 rotations each round ~1 ulp of the largest
# entry into the eigenvalues (measured up to ~2e-6 of it)
EIG_ATOL_SCALED = 1e-5
# the kept-subspace projector: float32 error over the eigenvalue gap at
# the threshold (>= 40 of ~1e4 here), ~1e-5
PROJ_ATOL = 1e-4
# the port's two orders, both float64 rounded to float32: an ulp apart
# at most
ORDER_ATOL_SCALED = 2.5e-7
# (c, s) from the half-angle identities against libm's cos / sin of
# 0.5 atan2 in float64: a few roundings of ~1e-16 each
HALF_ANGLE_ATOL = 1e-15
# K3's plain version against JAX's float32 solve (as K3_POSE_ATOL and
# K3_PROJ_ATOL in chip_smoke.py hold the kernel to its plain version)
POSE_ATOL = 1e-5


def _spectral(r, evals):
    q, _ = np.linalg.qr(r.normal(size=(6, 6)))
    return (q * np.float64(evals)) @ q.T


def _cases():
    r = np.random.default_rng(20261017)
    J = r.normal(0, 1, (300, 6)) * np.float64([3, 3, 3, 20, 20, 20])
    neg0 = np.diag([400.0, 20.0, 300.0, 10.0, 2000.0, 5.0])
    neg0[0, 1] = neg0[1, 0] = -0.0
    neg0[2, 3] = neg0[3, 2] = -0.0
    neg0[1, 2] = neg0[2, 1] = 3.0
    cases = {
        "spd": J.T @ J,
        "rank_deficient": _spectral(r, [0, 0, 60, 140, 1e3, 1e4]),
        "repeated": _spectral(r, [50, 50, 50, 400, 400, 2000]),
        "diagonal_swap": np.diag([5.0, 300.0, 2.0, 150.0, 1.0, 1000.0]),
        "negative_zero": neg0,
    }
    out = {}
    for k, H in cases.items():
        H = H.astype(np.float32)
        H = np.where(np.signbit(H) & (H == 0), H, (H + H.T) / 2)
        out[k] = H.astype(np.float32)
    return out


CASES = _cases()


def _projector(vecs, keep):
    return vecs @ np.diag(keep.astype(vecs.dtype)) @ vecs.T


@pytest.mark.parametrize("case", sorted(CASES))
def test_jacobi_orders_match_jax(case):
    """Eigenvalues (scaled by the largest entry) and the projector onto
    the eigenvectors at or above the threshold, the JAX package's float32
    Jacobi against the port's host Jacobi in the JAX order and in K3's
    round-robin order; the two orders against each other to an ulp."""
    H = CASES[case]
    scale = float(np.abs(H).max())
    e_j, v_j = (np.asarray(a) for a in jlin.jacobi_eigh6(jnp.asarray(H)))
    keep = e_j >= THRESHOLD
    results = {}
    for name, fn in (("cyclic", lin.jacobi_eigh6),
                     ("rounds", lin.jacobi_eigh6_rounds)):
        e_t, v_t = (a.numpy() for a in fn(torch.from_numpy(H)))
        np.testing.assert_allclose(e_t / scale, e_j / scale, rtol=0,
                                   atol=EIG_ATOL_SCALED, err_msg=name)
        np.testing.assert_array_equal(e_t >= THRESHOLD, keep, err_msg=name)
        np.testing.assert_allclose(_projector(v_t, keep),
                                   _projector(v_j, keep), rtol=0,
                                   atol=PROJ_ATOL, err_msg=name)
        results[name] = (e_t, _projector(v_t, keep))
    np.testing.assert_allclose(results["rounds"][0] / scale,
                               results["cyclic"][0] / scale, rtol=0,
                               atol=ORDER_ATOL_SCALED)
    np.testing.assert_allclose(results["rounds"][1], results["cyclic"][1],
                               rtol=0, atol=1e-6)


def _rotation_inputs(H, rounds):
    """(x, y) = (a_pp - a_qq + 1e-30, 2 a_pq) of every rotation of the
    host Jacobi in `rounds` (six sweeps), in float64, with the rotations
    applied by atan2's (c, s)."""
    A = H.astype(np.float64).tolist()
    V = np.eye(6).tolist()
    xs, ys = [], []
    for _ in range(6):
        for rnd in rounds:
            for p, q in rnd:
                x, y = A[p][p] - A[q][q] + 1e-30, 2.0 * A[p][q]
                xs.append(x)
                ys.append(y)
                t = 0.5 * math.atan2(y, x)
                lin._rotate_host(A, V, p, q, math.cos(t), math.sin(t))
    return xs, ys


def test_half_angle_matches_atan2():
    """givens_half_angle against cos / sin of 0.5 atan2(y, x) at every
    rotation of every case in both orders, and at the signed zeros and
    the quadrant edges, within HALF_ANGLE_ATOL; the sign of sin where
    y = +-0 and x < 0 (theta = +-pi/2) and the signed zero of sin where
    x > 0 as atan2's."""
    xs, ys = [], []
    for H in CASES.values():
        for rounds in (lin.ROUNDS6, [[pq] for pq in lin._PAIRS6]):
            x, y = _rotation_inputs(H, rounds)
            xs += x
            ys += y
    edge = [(1.0, 0.0), (1.0, -0.0), (-1.0, 0.0), (-1.0, -0.0), (0.0, 1.0),
            (0.0, -1.0), (0.0, 0.0), (0.0, -0.0), (-0.0, 0.0), (-0.0, -0.0),
            (-3.0, 1e-300), (-3.0, -1e-300), (1e-30, 2e-30), (-2.0, 2.0)]
    xs += [e[0] for e in edge]
    ys += [e[1] for e in edge]
    x = torch.tensor(xs, dtype=torch.float64)
    y = torch.tensor(ys, dtype=torch.float64)
    c, s = lin.givens_half_angle(x, y)
    theta = 0.5 * torch.atan2(y, x)
    torch.testing.assert_close(c, torch.cos(theta), rtol=0,
                               atol=HALF_ANGLE_ATOL)
    torch.testing.assert_close(s, torch.sin(theta), rtol=0,
                               atol=HALF_ANGLE_ATOL)
    assert torch.equal(torch.signbit(s), torch.signbit(torch.sin(theta)))
    assert len(xs) > 5 * 2 * 90


@pytest.mark.parametrize("case", sorted(CASES))
def test_gn_solve_plain_matches_jax(case):
    """K3's plain version (one lane a case: a step from normal equations
    H, g with enough rows; the same H with too few) against the JAX
    package's gn_solve_from_hg: flags and n_valid equal, pose within
    POSE_ATOL, projector within PROJ_ATOL, deltas within 1e-4. The
    rank-deficient H is singular: there the float32 solve of H + 1e-9 I
    is rounding noise in both packages, so only the lane with too few
    rows (no step) compares its pose."""
    r = np.random.default_rng(7)
    H = CASES[case]
    g = r.normal(0, 0.5, 6).astype(np.float32)
    pose0 = r.normal(0, 0.1, 6).astype(np.float32)
    jcfg, cfg = JMatchingConfig(), MatchingConfig()
    hg = np.stack([np.concatenate([H.reshape(-1), g, [n]])
                   for n in (300, 30)]).astype(np.float32)
    st = gn_solve.init_state(torch.from_numpy(np.stack([pose0, pose0])))
    new, _rows = gn_solve.solve_plain(torch.from_numpy(hg), st, cfg)
    for lane, n in enumerate((300, 30)):
        pose, proj, degen, conv, n_valid, d_r, d_t = jsm.gn_solve_from_hg(
            jnp.asarray(pose0), jnp.asarray(H), jnp.asarray(g),
            jnp.int32(n), jcfg)
        assert bool(new.degenerate[lane]) == bool(degen)
        assert bool(new.converged[lane]) == bool(conv)
        assert int(new.n_valid[lane]) == int(n_valid) == n
        assert int(new.it[lane]) == 1
        np.testing.assert_allclose(new.proj[lane].numpy(), np.asarray(proj),
                                   rtol=0, atol=PROJ_ATOL)
        if case == "rank_deficient" and n >= cfg.min_valid_points:
            continue
        np.testing.assert_allclose(new.pose[lane].numpy(), np.asarray(pose),
                                   rtol=0, atol=POSE_ATOL)
        np.testing.assert_allclose(
            [float(new.delta_r[lane]), float(new.delta_t[lane])],
            [float(d_r), float(d_t)], rtol=1e-4, atol=1e-6)
