"""Port parity of the scheduled scan-to-map solver and the cond-free
uniform step (JAX ops/scan_match.py:scan_to_map_scheduled,
pipeline/odometry.py:odom_step_uniform and _insert_keyframe_masked), and
of the plain version of the GN solve kernel K3 (ops/gn_solve.py).

The JAX uniform step replays rendered HDL-64 scans (450 of 1800 columns)
with the default configuration once for the module; the port steps each
scan from the JAX state before it (carried across with
pipeline/convert.py), so map and pose are identical at every comparison.
Positions must agree within 5e-3 m, angles within 5e-4 rad, keyframe
decisions exactly. (At this width some surf rows have five nearly
collinear neighbours, whose plane normal float32 rounding picks; the two
packages' H then differ by ~1%, so solver flags at the convergence
threshold are not compared.)
"""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp
import torch

from lis_slam_tpu.config import SensorConfig as JSensorConfig
from lis_slam_tpu.config import SlamConfig as JSlamConfig
from lis_slam_tpu.io import synthetic
from lis_slam_tpu.ops import scan_match as jsm
from lis_slam_tpu.pipeline import driver as jdriver, odometry as jodo
from lis_slam_torch.config import SensorConfig, SlamConfig
from lis_slam_torch.ops import gn_solve, scan_match
from lis_slam_torch.pipeline import convert, driver, odometry
from lis_slam_torch.utils import lin, se3

H = 450
N_SCANS = 6
START = 2  # the comparisons start from the JAX state before this scan
POS_ATOL = 5e-3  # m
ANG_ATOL = 5e-4  # rad


def _cfgs():
    sensor = dict(horizon_scan=H, max_raw_points=64 * H)
    return (JSlamConfig().replace(sensor=JSensorConfig(**sensor)),
            SlamConfig().replace(sensor=SensorConfig(**sensor)))


def _with_backend(cfg, backend):
    return cfg.replace(matching=dataclasses.replace(cfg.matching,
                                                    gn_backend=backend))


@pytest.fixture(scope="module")
def jax_run():
    """The JAX uniform step (allow_kf=True) over N_SCANS scans of the
    circuit of tests/test_torch_odometry.py, with each step's input state.
    One compile of the JAX step (~100 s on a CPU) serves the module."""
    jcfg, _ = _cfgs()
    world = synthetic.make_world(seed=5)
    gt = synthetic.circular_trajectory(N_SCANS + 1, radius=60.0, speed=8.0)
    clouds = [synthetic.render_scan(world, gt[i], None, horizon=H,
                                    seed=50 + i).points
              for i in range(N_SCANS)]
    clouds = [c[np.linalg.norm(c[:, :3], axis=1) > 0] for c in clouds]
    state = jodo.init_state(jcfg)
    states, outs = [], []
    for c in clouds:
        states.append({f: np.asarray(v) for f, v in state._asdict().items()})
        state, out = jodo.odom_step_uniform(state, jdriver.pad_scan(c, jcfg),
                                            jcfg)
        outs.append(out)
    states.append({f: np.asarray(v) for f, v in state._asdict().items()})
    return dict(clouds=clouds, states=states, outs=outs)


def _assert_pose(p, pj, msg):
    np.testing.assert_allclose(p[3:], pj[3:], atol=POS_ATOL, err_msg=msg)
    np.testing.assert_allclose(p[:3], pj[:3], atol=ANG_ATOL, err_msg=msg)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_scan_to_map_scheduled_matches_jax(jax_run, backend):
    """The scheduled solve of each scan from the JAX state before it (its
    constant-velocity guess, the port's matched clouds, the JAX maps)
    against the pose and correspondence count of the JAX uniform step,
    whose optimization it is; two lanes (the second with a perturbed
    guess) give lane 0 the one-lane result."""
    _, tcfg = _cfgs()
    tcfg = _with_backend(tcfg, backend)
    m = tcfg.matching
    for i in range(START, N_SCANS):
        st = convert.odom_state_from_numpy(jax_run["states"][i])
        fc = odometry.preprocess(driver.pad_scan(jax_run["clouds"][i], tcfg),
                                 tcfg)
        clouds = odometry._matched_clouds(fc, tcfg)
        maps = (st.map_corner, st.map_corner_mask, st.map_surf,
                st.map_surf_mask)
        guess = se3.matrix_to_pose(se3.pose_to_matrix(st.pose) @ st.incr)
        out = scan_match.scan_to_map_scheduled(
            guess, *clouds, *maps, m, m.uniform_iters, m.uniform_refresh)
        ref = jax_run["outs"][i]
        _assert_pose(out.pose.numpy(), np.asarray(ref.pose), f"scan {i}")
        assert abs(int(out.n_valid) - int(ref.n_valid)) <= 0.02 * int(
            ref.n_valid)
        assert 1 <= int(out.it) <= m.uniform_iters
        if i == START:
            off = torch.tensor([0.004, -0.002, 0.01, 0.15, -0.1, 0.02])
            lanes = scan_match.scan_to_map_scheduled(
                torch.stack([guess, guess + off]),
                *(torch.stack([t, t]) for t in (*clouds, *maps)), m,
                m.uniform_iters, m.uniform_refresh)
            for f, a in zip(scan_match.GNState._fields, out):
                torch.testing.assert_close(getattr(lanes, f)[0], a, rtol=0,
                                           atol=1e-5, msg=f)
            _assert_pose(lanes.pose[1].numpy(), np.asarray(ref.pose),
                         "perturbed lane")


@pytest.mark.parametrize("allow_kf", [True, False])
def test_odom_step_uniform_matches_jax(jax_run, allow_kf):
    """Each scan stepped from the JAX state before it. allow_kf=True: the
    pose, the keyframe decision, the keyframe count and map counts within
    2% of the JAX state after it. allow_kf=False: the same pose (the
    merge follows the solve, in both packages), no keyframe, and the
    state's map and ring bookkeeping left as they were."""
    _, tcfg = _cfgs()
    n_kf = 0
    for i in range(START, N_SCANS):
        before = convert.odom_state_from_numpy(jax_run["states"][i])
        state, out = odometry.odom_step_uniform(
            convert.odom_state_from_numpy(jax_run["states"][i]),
            driver.pad_scan(jax_run["clouds"][i], tcfg), tcfg,
            allow_kf=allow_kf)
        ref, after = jax_run["outs"][i], jax_run["states"][i + 1]
        assert isinstance(out.is_keyframe, torch.Tensor)
        _assert_pose(out.pose.numpy(), np.asarray(ref.pose), f"scan {i}")
        assert abs(int(out.n_valid) - int(ref.n_valid)) <= 0.02 * int(
            ref.n_valid)
        assert int(state.frame_idx) == int(after["frame_idx"])
        if allow_kf:
            assert bool(out.is_keyframe) == bool(ref.is_keyframe), f"scan {i}"
            n_kf += int(out.is_keyframe)
            for f in ("kf_count", "kf_head"):
                assert int(getattr(state, f)) == int(after[f]), (i, f)
            for f in ("map_corner_mask", "map_surf_mask"):
                n, nj = int(getattr(state, f).sum()), int(after[f].sum())
                assert abs(n - nj) <= 0.02 * nj, (i, f)
        else:
            assert not bool(out.is_keyframe)
            for f in ("kf_poses", "kf_count", "kf_head", "last_kf_pose",
                      "map_corner", "map_corner_mask", "map_surf",
                      "map_surf_mask"):
                assert torch.equal(getattr(state, f), getattr(before, f)), f
    assert n_kf >= 1 or not allow_kf  # the masked merge ran in the window


def test_insert_keyframe_masked_without_keyframe(jax_run):
    """is_kf False leaves the ring bookkeeping equal and the map's content
    the same set of points; is_kf True advances it as the host insert."""
    _, tcfg = _cfgs()
    state = convert.odom_state_from_numpy(jax_run["states"][START])
    fc = odometry.preprocess(driver.pad_scan(jax_run["clouds"][START], tcfg),
                             tcfg)
    pose = torch.from_numpy(np.array(jax_run["outs"][START].pose))
    lanes = odometry.OdomState(*(torch.stack([t, t]) for t in state))
    fcl = type(fc)(*(torch.stack([t, t]) for t in fc))
    new = odometry._insert_keyframe_masked(
        lanes, fcl, torch.stack([pose, pose]), torch.tensor([False, True]),
        tcfg)
    for f in ("kf_poses", "kf_count", "kf_head", "last_kf_pose"):
        assert torch.equal(getattr(new, f)[0], getattr(state, f)), f
    for pts, mask, old_pts, old_mask in (
            (new.map_corner, new.map_corner_mask, state.map_corner,
             state.map_corner_mask),
            (new.map_surf, new.map_surf_mask, state.map_surf,
             state.map_surf_mask)):
        a = pts[0][mask[0]].numpy()
        b = old_pts[old_mask].numpy()
        assert a.shape == b.shape
        np.testing.assert_array_equal(a[np.lexsort(a.T)], b[np.lexsort(b.T)])
    host = odometry._insert_keyframe(state, fc, pose, tcfg)
    for f in odometry.OdomState._fields:
        a, h = getattr(new, f)[1], getattr(host, f)
        if a.is_floating_point():  # the lanes transform rounds its own way
            torch.testing.assert_close(a, h, rtol=0, atol=1e-5, msg=f)
        else:
            assert torch.equal(a, h), f


def _normal_equations(seed, n_lanes):
    """Packed (B, 43) normal equations of random well- and ill-conditioned
    problems (one lane degenerate, one with too few rows)."""
    r = np.random.default_rng(seed)
    hg = []
    for b in range(n_lanes):
        J = r.normal(0, 1, (300, 6)) * np.float64([3, 3, 3, 20, 20, 20])
        if b % 3 == 1:
            J[:, 5] *= 1e-3  # a weak direction: eigenvalue below 100
        H = (J.T @ J).astype(np.float32)
        g = r.normal(0, 5e-3 if b % 2 else 50, 6).astype(np.float32)
        n = 30 if b % 4 == 3 else 300
        hg.append(np.concatenate([H.reshape(-1), g, [n]]).astype(np.float32))
    return torch.from_numpy(np.stack(hg))


def test_gn_solve_plain_matches_per_lane_solve():
    """K3's plain version: per lane gn_solve_from_hg (with K3's Jacobi
    order, lin.jacobi_eigh6_rounds) then the masked update; a converged
    lane stays frozen (only `it` of an active lane moves), and its scalar
    rows are pack_scalars' for the new pose."""
    from lis_slam_torch.ops import gn_cuda

    cfg = SlamConfig().matching
    hg = _normal_equations(1, 8)
    b = hg.shape[0]
    r = np.random.default_rng(2)
    pose0 = torch.from_numpy(r.normal(0, 0.1, (b, 6)).astype(np.float32))
    st = gn_solve.init_state(pose0)
    st = st._replace(converged=torch.tensor([i in (1, 5) for i in range(b)]),
                     it=torch.full((b,), 3, dtype=torch.int32))
    new, rows = gn_solve.solve(hg, st, cfg)
    for i in range(b):
        if bool(st.converged[i]):
            for f in scan_match.GNState._fields:
                assert torch.equal(getattr(new, f)[i], getattr(st, f)[i]), f
            continue
        pose, proj, degen, conv, n_valid, d_r, d_t = (
            scan_match.gn_solve_from_hg(pose0[i], hg[i, :36].reshape(6, 6),
                                        hg[i, 36:42], int(hg[i, 42]), cfg,
                                        eigh=lin.jacobi_eigh6_rounds))
        assert torch.equal(new.pose[i], pose) and torch.equal(new.proj[i],
                                                               proj)
        assert (bool(new.degenerate[i]), bool(new.converged[i])) == (degen,
                                                                     conv)
        assert int(new.n_valid[i]) == n_valid and int(new.it[i]) == 4
        assert float(new.delta_r[i]) == pytest.approx(d_r, rel=1e-6)
        assert float(new.delta_t[i]) == pytest.approx(d_t, rel=1e-6)
    assert bool(new.degenerate[4])  # the weak direction was projected out
    assert bool(new.converged[7])  # too few rows: converged, x = 0
    assert torch.equal(new.pose[7], pose0[7])
    for i in range(b):
        for j, mode in enumerate(("corner", "surf")):
            torch.testing.assert_close(
                rows[i, j], gn_cuda.pack_scalars(new.pose[i], cfg, mode),
                rtol=0, atol=1e-6)
    assert torch.equal(gn_solve.scalar_rows(new, cfg), rows)


def test_batched_lin_matches_single():
    """solve6_spd_batched and jacobi_eigh6_batched (the batched plain
    versions of K3's solve and eigendecomposition) against the one-matrix
    host functions, lane by lane."""
    hg = _normal_equations(3, 5)
    H, g = hg[:, :36].reshape(-1, 6, 6), hg[:, 36:42]
    x = lin.solve6_spd_batched(H, g)
    e, v = lin.jacobi_eigh6_batched(H)
    for i in range(H.shape[0]):
        torch.testing.assert_close(x[i], lin.solve6_spd(H[i], g[i]),
                                   rtol=1e-5, atol=1e-7)
        e1, v1 = lin.jacobi_eigh6(H[i])
        torch.testing.assert_close(e[i], e1, rtol=1e-6, atol=1e-4)
        # eigenvectors up to sign
        dots = torch.abs(torch.sum(v[i] * v1, dim=0))
        torch.testing.assert_close(dots, torch.ones(6), rtol=0, atol=1e-5)
