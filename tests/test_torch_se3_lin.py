"""Port parity: utils/se3.py and utils/lin.py against the JAX package on
random batches (numpy inputs from a seed, fed to both)."""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp
import torch

from lis_slam_tpu.utils import lin as jlin, se3 as jse3
from lis_slam_torch.utils import lin as tlin, se3 as tse3

ATOL = 1e-5


def _rng():
    return np.random.default_rng(1234)


def _poses(r, n=64):
    rpy = r.uniform(-1.2, 1.2, (n, 3))
    xyz = r.uniform(-50, 50, (n, 3))
    return np.concatenate([rpy, xyz], 1).astype(np.float32)


def _close(t, j, atol=ATOL, rtol=0.0):
    np.testing.assert_allclose(t.detach().cpu().numpy(), np.asarray(j),
                               atol=atol, rtol=rtol)


@pytest.mark.parametrize("fn", ["pose_to_matrix", "transform_inverse_pose",
                                "matrix_to_pose", "euler_to_quat",
                                "quat_to_euler"])
def test_se3_batched(fn):
    p = _poses(_rng())
    if fn == "pose_to_matrix":
        _close(tse3.pose_to_matrix(torch.from_numpy(p)),
               jse3.pose_to_matrix(jnp.asarray(p)))
    elif fn == "transform_inverse_pose":
        _close(tse3.transform_inverse(tse3.pose_to_matrix(torch.from_numpy(p))),
               jse3.transform_inverse(jse3.pose_to_matrix(jnp.asarray(p))),
               atol=5e-5, rtol=1e-6)
    elif fn == "matrix_to_pose":
        T = np.array(jse3.pose_to_matrix(jnp.asarray(p)))
        _close(tse3.matrix_to_pose(torch.from_numpy(T)),
               jse3.matrix_to_pose(jnp.asarray(T)), atol=2e-5)
    elif fn == "euler_to_quat":
        _close(tse3.euler_to_quat(torch.from_numpy(p[:, :3])),
               jse3.euler_to_quat(jnp.asarray(p[:, :3])))
    else:
        q = np.array(jse3.euler_to_quat(jnp.asarray(p[:, :3])))
        _close(tse3.quat_to_euler(torch.from_numpy(q)),
               jse3.quat_to_euler(jnp.asarray(q)), atol=2e-5)


@pytest.mark.parametrize("scale", [0.0, 1e-7, 1e-3, 0.5, 2.5])
def test_so3_exp_log_hat_vee(scale):
    """Rodrigues and its log against the JAX package, across the small-angle
    branch (theta^2 < 1e-12, where the far branch would be 0/0 and is
    guarded) and large angles; finite in float64 too, as the host IMU chain
    runs them."""
    r = _rng()
    w = (r.normal(size=(32, 3)) * scale).astype(np.float32)
    w[0] = 0.0
    pts = r.normal(size=(32, 5, 3)).astype(np.float32)
    Rt = tse3.so3_exp(torch.from_numpy(w))
    Rj = jse3.so3_exp(jnp.asarray(w))
    _close(Rt, Rj, atol=1e-6)
    _close(tse3.so3_log(Rt), jse3.so3_log(Rj), atol=2e-5)
    _close(tse3.hat(torch.from_numpy(w)), jse3.hat(jnp.asarray(w)), atol=0)
    _close(tse3.vee(tse3.hat(torch.from_numpy(w))), w, atol=0)
    _close(tse3.apply_rotation(Rt, torch.from_numpy(pts)),
           jse3.apply_rotation(Rj, jnp.asarray(pts)), atol=1e-5)
    w64 = torch.from_numpy(w.astype(np.float64))
    R64 = tse3.so3_exp(w64)
    assert R64.dtype == torch.float64 and torch.isfinite(R64).all()
    log64 = tse3.so3_log(R64)
    assert torch.isfinite(log64).all()
    if scale < 1.0:  # inside [0, pi): the log inverts the exp
        _close(log64, w.astype(np.float64), atol=1e-9)


@pytest.mark.parametrize("scale", [0.0, 1e-7, 1e-3, 0.5, 2.5])
def test_se3_exp_log(scale):
    """SE(3) exp/log (ICP update, pose-graph residuals) against the JAX
    package across the small-angle series and large angles: rotation at
    1e-6, log at 5e-5 (float32, the log's V^-1 divides by sin(theta/2)).
    Translation at 1e-5 plus, outside the series branch, |rho| x 2 ulp /
    theta: both packages take (1 - cos theta) / theta^2 in float32, which
    cancels to a few ulp of 1 over theta^2 near theta = 1e-3, so the two
    math libraries' last-bit cosines differ there by up to ~1e-1 of it."""
    r = _rng()
    xi = np.concatenate([r.normal(size=(32, 3)) * 3.0,
                         r.normal(size=(32, 3)) * scale], 1).astype(np.float32)
    xi[0] = 0.0
    Tt = tse3.se3_exp(torch.from_numpy(xi)).numpy()
    Tj = np.array(jse3.se3_exp(jnp.asarray(xi)))
    np.testing.assert_allclose(Tt[:, :3, :3], Tj[:, :3, :3], atol=1e-6,
                               rtol=0)
    th2 = np.sum(xi[:, 3:].astype(np.float64) ** 2, 1)
    ulp2_over_th = np.where(th2 < 1e-12, 0.0,
                            2.4e-7 / np.sqrt(np.maximum(th2, 1e-24)))
    bound = 1e-5 + np.linalg.norm(xi[:, :3], axis=1) * ulp2_over_th
    assert np.all(np.abs(Tt[:, :3, 3] - Tj[:, :3, 3]).max(1) <= bound)
    _close(tse3.se3_log(torch.from_numpy(Tj)), jse3.se3_log(jnp.asarray(Tj)),
           atol=5e-5)
    if scale in (0.0, 1e-7, 0.5):  # inside [0, pi), away from the
        # cancellation: the log inverts the exp
        _close(tse3.se3_log(torch.from_numpy(Tt)), xi, atol=5e-5)


def test_transform_points_and_slerp():
    r = _rng()
    p = _poses(r, 1)[0]
    pts = r.uniform(-40, 40, (500, 3)).astype(np.float32)
    T_t = tse3.pose_to_matrix(torch.from_numpy(p))
    T_j = jse3.pose_to_matrix(jnp.asarray(p))
    _close(tse3.transform_points(T_t, torch.from_numpy(pts)),
           jse3.transform_points(T_j, jnp.asarray(pts)), atol=1e-4)
    q0 = jse3.euler_to_quat(jnp.asarray([0.1, 0.0, 0.0]))
    q1 = jse3.euler_to_quat(jnp.asarray([0.3, 0.0, 0.0]))
    for t in (0.0, 0.1, 0.5, 1.0):
        _close(tse3.quat_slerp(torch.tensor(np.asarray(q0)),
                               torch.tensor(np.asarray(q1)), t),
               jse3.quat_slerp(q0, q1, t))
    v = np.array([-2000.0, -3.0, 0.5, 3.0, 2000.0], np.float32)
    _close(tse3.constrain_angle(torch.from_numpy(v), 1000.0),
           jse3.constrain_angle(jnp.asarray(v), 1000.0))


def _spd3(r, n=256):
    """Covariances of 5-point clusters: lines, planes and blobs."""
    base = r.normal(0, 1, (n, 5, 3))
    base[: n // 3, :, 1:] *= 0.01  # line-like
    base[n // 3: 2 * n // 3, :, 2] *= 0.01  # plane-like
    c = base - base.mean(1, keepdims=True)
    return np.einsum("nki,nkj->nij", c, c).astype(np.float32), \
        base.astype(np.float32)


@pytest.mark.parametrize("kind,part", [("line", slice(0, 85)),
                                       ("plane", slice(85, 170)),
                                       ("blob", slice(170, 256))])
def test_eigvalsh3(kind, part):
    """atol 1e-5 relative to each matrix's largest eigenvalue. For a line
    the two small eigenvalues are nearly equal and the closed form takes
    acos next to 1, whose slope is unbounded: one float32 ulp of its
    argument moves the split between them by ~1e-4 of the largest in
    either framework (their sum and the largest stay well conditioned),
    so for lines the split itself is not compared."""
    A = _spd3(_rng())[0][part]
    e_t = tlin.eigvalsh3(torch.from_numpy(A)).numpy()
    e_j = np.asarray(jlin.eigvalsh3(jnp.asarray(A)))
    scale = np.max(np.abs(e_j), axis=1, keepdims=True)
    e_t, e_j = e_t / scale, e_j / scale
    if kind == "line":
        e_t = np.stack([e_t[:, 0] + e_t[:, 1], e_t[:, 2]], 1)
        e_j = np.stack([e_j[:, 0] + e_j[:, 1], e_j[:, 2]], 1)
    np.testing.assert_allclose(e_t, e_j, atol=ATOL)


@pytest.mark.parametrize("name,part", [("principal_eigvec3", slice(0, 85)),
                                       ("smallest_eigvec3", slice(85, 170))])
def test_projector_eigvecs(name, part):
    """On the clusters each is used for — lines (principal direction) and
    planes (normal) — where the eigenvector is well defined. Both pick the
    first max-norm projector column, so even the signs agree."""
    A = _spd3(_rng())[0][part]
    e_t = tlin.eigvalsh3(torch.from_numpy(A))
    e_j = jlin.eigvalsh3(jnp.asarray(A))
    _close(getattr(tlin, name)(torch.from_numpy(A), e_t),
           getattr(jlin, name)(jnp.asarray(A), e_j), atol=1e-4)


def test_solve_plane_lsq():
    pts = _spd3(_rng())[1][85:170]  # plane-like clusters
    n_t, d_t = tlin.solve_plane_lsq(torch.from_numpy(pts))
    n_j, d_j = jlin.solve_plane_lsq(jnp.asarray(pts))
    _close(n_t, n_j, atol=1e-4)
    _close(d_t, d_j, atol=1e-4)


def test_inv3_and_solve6_spd():
    r = _rng()
    A, _ = _spd3(r, 32)
    A = A + np.eye(3, dtype=np.float32)
    _close(tlin.inv3(torch.from_numpy(A)), jlin.inv3(jnp.asarray(A)),
           atol=1e-5, rtol=1e-5)
    for _ in range(8):
        J = r.normal(0, 1, (200, 6)).astype(np.float32)
        H = (J.T @ J).astype(np.float32)
        g = r.normal(0, 1, 6).astype(np.float32)
        _close(tlin.solve6_spd(torch.from_numpy(H), torch.from_numpy(g)),
               jlin.solve6_spd(jnp.asarray(H), jnp.asarray(g)), atol=ATOL,
               rtol=1e-4)


@pytest.mark.parametrize("case", ["well_conditioned", "degenerate_axis"])
def test_jacobi_eigh6(case):
    r = _rng()
    J = r.normal(0, 1, (300, 6)).astype(np.float32)
    if case == "degenerate_axis":
        J[:, 2] *= 1e-3  # one direction almost unconstrained
    H = J.T @ J
    e_t, v_t = tlin.jacobi_eigh6(torch.from_numpy(H))
    e_j, v_j = jlin.jacobi_eigh6(jnp.asarray(H))
    scale = float(np.max(np.abs(H)))
    _close(e_t / scale, np.asarray(e_j) / scale, atol=ATOL)
    # eigenvector signs are arbitrary: compare the spectral projectors of
    # the kept (above-threshold) subspace, as gn_solve_from_hg builds them
    thr = 1e-2 * scale
    keep_t = (e_t >= thr).float()
    keep_j = (e_j >= thr).astype(np.float32)
    np.testing.assert_array_equal(keep_t.numpy(), np.asarray(keep_j))
    P_t = v_t @ torch.diag(keep_t) @ v_t.T
    P_j = v_j @ jnp.diag(keep_j) @ v_j.T
    _close(P_t, P_j, atol=1e-4)


def test_quat_rot_round_trips():
    """quat_to_rot / rot_to_quat against the JAX package's on the same
    seeded rotations (1e-5), the quaternion round trip within 1e-6 up to
    sign, and the zero quaternion's identity."""
    r = _rng()
    q = r.normal(size=(256, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    R_t = tse3.quat_to_rot(torch.from_numpy(q))
    _close(R_t, jse3.quat_to_rot(jnp.asarray(q)))
    R = R_t.numpy()
    qt = tse3.rot_to_quat(torch.from_numpy(R))
    _close(qt, jse3.rot_to_quat(jnp.asarray(R)))
    back = qt.numpy() * np.sign(np.sum(qt.numpy() * q, 1, keepdims=True))
    np.testing.assert_allclose(back, q, atol=1e-6)
    _close(tse3.quat_to_rot(torch.zeros(4)), np.eye(3), atol=0)
