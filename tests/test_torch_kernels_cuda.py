"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card. Every test here is marked `cuda` and skips without a GPU; the
file imports no JAX, so it runs where only the port is installed:

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda --noconftest

(`--noconftest`: tests/conftest.py sets up JAX for the rest of the suite.)

Kernels: K1 exact kNN (ops/knn_cuda.py, csrc/knn.cu), K2 fused GN
accumulation (ops/gn_cuda.py, csrc/gn.cu), both also over lanes (the
scheduled solver's batched replay: each lane bit-equal to a one-lane
launch), and K3 the GN solve and masked update of the scheduled solver
(ops/gn_solve.py, csrc/gn_solve.cu). chip_smoke.py runs the same
comparisons at the front end's, the back end's and the batched replay's
full shapes.
"""

import numpy as np
import pytest
import torch

from lis_slam_torch.config import SlamConfig
from lis_slam_torch.ops import gn_cuda, knn_cuda
from lis_slam_torch.utils import se3

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda", 0)


def _clouds(dev, n_q, n_ref, seed=0):
    r = np.random.default_rng(seed)
    q = torch.from_numpy(r.uniform(-20, 20, (n_q, 3)).astype(np.float32))
    ref = torch.from_numpy(r.uniform(-20, 20, (n_ref, 3)).astype(np.float32))
    mask = torch.from_numpy(r.uniform(size=n_ref) > 0.2)
    return q.to(dev), ref.to(dev), mask.to(dev)


@pytest.mark.parametrize("k", [1, 8])
@pytest.mark.parametrize("cap", [None, 4.0])
@pytest.mark.parametrize("n_q,n_ref", [(1024, 16384), (1000, 3001)])
def test_knn_kernel_matches_plain(dev, k, cap, n_q, n_ref):
    q, ref, mask = _clouds(dev, n_q, n_ref)
    before = knn_cuda.knn.launches
    d, i, xyz = knn_cuda.knn(q, ref, mask, k=k, max_sq_dist=cap)
    dp, ip, _ = knn_cuda.knn_plain(q, ref, mask, k=k, max_sq_dist=cap)
    torch.cuda.synchronize()
    assert knn_cuda.knn.launches == before + 1
    assert torch.equal(i < 0, torch.isinf(d))
    assert torch.equal(d, dp) and torch.equal(i, ip)  # bit-equal
    near = torch.where((i >= 0)[..., None], ref[i.clamp(min=0).long()], 0.0)
    assert torch.equal(near, xyz)


def test_knn_kernel_rejects_unbuilt_k(dev):
    q, ref, mask = _clouds(dev, 64, 256)
    with pytest.raises(ValueError):
        knn_cuda.knn(q, ref, mask, k=7)
    with pytest.raises(ValueError):
        knn_cuda.knn(q.t().contiguous().t(), ref, mask, k=8)


def _gn_cloud(dev, mode, n_q, k=8, seed=1, w_hi=1.5):
    """A well-conditioned cloud for K2 seen from _GN_POSE (random spreads,
    not collinear neighbours): (pts, mask, cand, cand_ok, weight)."""
    r = np.random.default_rng(seed)
    base = r.uniform(-20, 20, (n_q, 1, 3))
    if mode == "corner":  # candidates along vertical lines
        cand = base + np.stack([r.normal(0, 0.01, (n_q, k)),
                                r.normal(0, 0.01, (n_q, k)),
                                r.uniform(-0.5, 0.5, (n_q, k))], -1)
    else:  # candidates on horizontal patches
        cand = base + np.stack([r.uniform(-0.5, 0.5, (n_q, k)),
                                r.uniform(-0.5, 0.5, (n_q, k)),
                                r.normal(0, 0.005, (n_q, k))], -1)
    pose = torch.tensor(_GN_POSE, device=dev)
    T_inv = se3.transform_inverse(se3.pose_to_matrix(pose))
    world = torch.from_numpy((base[:, 0] + r.normal(0, 0.05, (n_q, 3)))
                             .astype(np.float32)).to(dev)
    return (se3.transform_points(T_inv, world).contiguous(),
            torch.from_numpy(r.uniform(size=n_q) > 0.1).to(dev),
            torch.from_numpy(cand.astype(np.float32)).to(dev),
            torch.from_numpy(r.uniform(size=(n_q, k)) > 0.1).to(dev),
            torch.from_numpy(r.uniform(0.5, w_hi, n_q).astype(np.float32))
            .to(dev))


_GN_POSE = (0.01, -0.02, 0.05, 0.3, -0.2, 0.04)


def _assert_scaled_close(a, b):
    scale = float(b.abs().max()) + 1e-9
    torch.testing.assert_close(a / scale, b / scale, atol=2e-4, rtol=0)


@pytest.mark.parametrize("mode", ["corner", "surf"])
def test_gn_kernel_matches_plain(dev, mode):
    """Well-conditioned fits, one cloud: H and g to atol 2e-4 after
    scaling, as tests/test_pallas_gn.py; two launches give the same bits."""
    k = 8
    pose = torch.tensor(_GN_POSE, device=dev)
    args = (*_gn_cloud(dev, mode, 1000, k),
            gn_cuda.pack_scalars(pose, SlamConfig().matching, mode))
    before = gn_cuda.gn_iteration_vec.launches
    H, g, nv = gn_cuda.gn_partials(*args, mode, k)
    H2, g2, _ = gn_cuda.gn_partials(*args, mode, k)
    Hp, gp, nvp = gn_cuda.gn_partials_plain(*args, mode, k)
    torch.cuda.synchronize()
    assert gn_cuda.gn_iteration_vec.launches == before + 2
    assert torch.equal(H, H2) and torch.equal(g, g2)  # no racing atomics
    assert int(nvp) > 100 and int(nv) == int(nvp)
    _assert_scaled_close(H, Hp)
    _assert_scaled_close(g, gp)


def _scaled_err(a, b):
    return float((a - b).abs().max()) / (float(b.abs().max()) + 1e-9)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("seeds", [(1, 1), (4, 5)])
@pytest.mark.parametrize("at_optimum", [True, False])
def test_gn_kernel_two_clouds_one_launch(dev, weighted, seeds, at_optimum):
    """One GN iteration, both clouds in one launch, against the sum of the
    plain version over the two, on the same scalar rows (made on the
    host): n_valid exact; H and g no further from the float64 plain sum
    than 2e-4 scaled, or than twice the float32 plain sum where that is
    further (a surf row whose neighbours are nearly collinear has an
    ill-defined normal, and at the optimum g is a sum of cancelling
    terms). Back-to-back launches, with one of another grid between them,
    give the same bits (the last block resets the ticket)."""
    k = 8
    cfg = SlamConfig().matching
    pose = torch.tensor(_GN_POSE)
    if not at_optimum:
        pose = pose + torch.tensor([0.002, -0.001, 0.004, 0.05, -0.03, 0.01])
    corner = _gn_cloud(dev, "corner", 1000, k, seed=seeds[0])
    surf = _gn_cloud(dev, "surf", 2000, k, seed=seeds[1])
    cw, sw = (corner[4], surf[4]) if weighted else (None, None)
    args = (pose, *corner[:4], *surf[:4], cw, sw, cfg, k)
    before = gn_cuda.gn_iteration_vec.launches
    v1 = gn_cuda.gn_iteration_vec(*args)
    other = gn_cuda.gn_iteration_vec(pose, *surf[:4], *corner[:4], None,
                                     None, cfg, k)
    v2 = gn_cuda.gn_iteration_vec(*args)
    torch.cuda.synchronize()
    assert gn_cuda.gn_iteration_vec.launches == before + 3
    assert torch.equal(v1, v2) and not torch.equal(v1, other)
    rows = gn_cuda.scalar_rows(pose, cfg).to(dev)

    def plain(dtype):
        sums = [gn_cuda.gn_partials_plain(*(
            a.to(dtype) if a.is_floating_point() else a
            for a in (*c[:4], c[4] if weighted else torch.ones_like(c[4]),
                      rows[i])), m, k)
            for i, (m, c) in enumerate((("corner", corner), ("surf", surf)))]
        return [a + b for a, b in zip(*sums)]

    Hp, gp, nvp = plain(torch.float32)
    Hd, gd, _ = plain(torch.float64)
    H, g, nv = gn_cuda.gn_iteration_hg(*args)
    assert torch.equal(H.reshape(-1), v1[:36]) and torch.equal(g, v1[36:42])
    assert nv.dtype == torch.int32 and int(nv) == int(nvp) > 1000
    assert torch.allclose(H, H.T, atol=0)  # the full symmetric H
    for a, a32, a64 in ((H, Hp, Hd), (g, gp, gd)):
        e_k = _scaled_err(a.double(), a64)
        e_p = _scaled_err(a32.double(), a64)
        assert e_k <= max(2e-4, 2.0 * e_p), (e_k, e_p)


def _adversarial_knn(dev, case, tile):
    """A K1 case built against the kernel's tiles: a half-metre lattice
    map (many exactly tied distances, some exactly at the cap) over 8
    tiles and a ragged ninth."""
    r = np.random.default_rng(31)
    n = 8 * tile + 17
    ref = (r.integers(-6, 6, (n, 3)) * 0.5).astype(np.float32)
    mask = np.ones(n, bool)
    q_n = 1000
    if case == "faces":  # queries on the faces and corners of tile boxes
        lo, hi = (b.numpy() for b in knn_cuda.tile_aabb_plain(
            torch.from_numpy(ref), torch.from_numpy(mask), tile))
        t = r.integers(0, lo.shape[0], (q_n, 3))
        pick = r.integers(0, 2, (q_n, 3))
        q = np.where(pick == 0, lo[t, [0, 1, 2]], hi[t, [0, 1, 2]])
    elif case == "cap_ties":  # lattice queries: d = 4.0 exactly occurs
        q = (r.integers(-6, 6, (q_n, 3)) * 0.5)
    else:
        q = r.uniform(-3, 3, (q_n, 3))
    if case == "empty_tiles":  # every other tile masked out
        for t in range(0, 9, 2):
            mask[t * tile:(t + 1) * tile] = False
    elif case == "single":
        mask[:] = False
        mask[3 * tile + 5] = True
    elif case == "ragged_q":
        q = q[:q_n - 25]  # not a multiple of the 32-query group
    elif case == "empty_map":
        mask[:] = False
    return (torch.from_numpy(np.ascontiguousarray(q, np.float32)).to(dev),
            torch.from_numpy(ref).to(dev), torch.from_numpy(mask).to(dev))


@pytest.mark.parametrize("k,cap", [(8, 4.0), (5, 1.0), (1, None)])
@pytest.mark.parametrize("case", ["faces", "cap_ties", "empty_tiles",
                                  "single", "ragged_q", "empty_map"])
def test_knn_kernel_adversarial_bit_equal(dev, case, k, cap):
    """K1's tile skipping is exact: bit-equal to the plain version with
    queries on tile faces, ties exactly at the cap, interleaved empty
    tiles, one valid point, a ragged query group and an empty map."""
    tile = knn_cuda._lib().lis_knn_tile()
    q, ref, mask = _adversarial_knn(dev, case, tile)
    d, i, xyz = knn_cuda.knn(q, ref, mask, k=k, max_sq_dist=cap)
    dp, ip, xp = knn_cuda.knn_plain(q, ref, mask, k=k, max_sq_dist=cap)
    torch.cuda.synchronize()
    assert torch.equal(d, dp) and torch.equal(i, ip) and torch.equal(xyz, xp)
    if case == "empty_map":
        assert bool(torch.isinf(d).all()) and bool((i == -1).all())
    done, total = knn_cuda.tiles_computed(q, ref, mask, k=k, max_sq_dist=cap)
    assert 0 <= done <= total
    if case == "empty_map":
        assert done == 0  # every tile's box is empty


def test_kernels_at_lio_shapes(dev):
    """K1 and K2 on the LiDAR-inertial path's own clouds: the matched
    clouds of a motion-distorted VLP-16 sweep (gyro-deskewed) against the
    map that LioOdometry built on the card, lio_config at full width (as
    chip_smoke.py phase lio). K1 equal to its plain version off exact
    ties; K2 no further from the float64 plain version than twice the
    float32 one (the circuit bound: real surf rows can have collinear
    neighbours)."""
    import dataclasses

    from lis_slam_torch.config import lio_config
    from lis_slam_torch.io import synthetic_torch
    from lis_slam_torch.pipeline import driver, lio, odometry

    cfg = lio_config()
    cfg = cfg.replace(matching=dataclasses.replace(cfg.matching,
                                                   gn_backend="pallas"))
    raw, gt = synthetic_torch.render_sequence_device(
        4, seed=5, device=dev, distorted=True, n_scan=16,
        elevations=np.linspace(15.0, -15.0, 16))
    R_ext = np.asarray(cfg.imu.extrinsic_rot)
    system = lio.LioOdometry(cfg, dev)
    for i, (p, _l, v) in enumerate(raw):
        g, a, t = synthetic_torch.imu_rows(gt[i], gt[i + 1])
        cloud = p[v].cpu().numpy()
        pose = system.process_scan(cloud, t + i * 0.1, g @ R_ext,
                                   a @ R_ext, i * 0.1)
    sin = driver.pad_scan(cloud, cfg, dev, imu_time=t + 0.3, imu_gyro=g,
                          scan_start=0.3)
    qc, qc_mask, qs, qs_mask = odometry._matched_clouds(
        odometry.preprocess(sin, cfg), cfg)
    st, k = system.state, cfg.matching.nn_cache_k
    T = se3.pose_to_matrix(pose)
    for mode, q, q_mask, ref, ref_mask in (
            ("corner", qc, qc_mask, st.map_corner, st.map_corner_mask),
            ("surf", qs, qs_mask, st.map_surf, st.map_surf_mask)):
        qw = se3.transform_points(T, q).contiguous()
        d, i, cand = knn_cuda.knn(qw, ref, ref_mask, k=k, max_sq_dist=4.0)
        dp, ip, _ = knn_cuda.knn_plain(qw, ref, ref_mask, k=k,
                                       max_sq_dist=4.0)
        assert int(torch.isfinite(dp).sum()) > 0
        assert torch.equal(d, dp) and torch.equal(i, ip)  # bit-equal
        args = (q.contiguous(), q_mask.contiguous(), cand,
                (d < 4.0).contiguous(), torch.ones(q.shape[0], device=dev),
                gn_cuda.pack_scalars(pose, cfg.matching, mode).contiguous())
        H, g_, nv = gn_cuda.gn_partials(*args, mode, k)
        Hp, gp, nvp = gn_cuda.gn_partials_plain(*args, mode, k)
        Hd, gd, _ = gn_cuda.gn_partials_plain(
            *(x.double() if x.is_floating_point() else x for x in args),
            mode, k)
        assert int(nvp) > 0 and int(nv) == int(nvp)

        def err(a, b, ref_a, ref_b):
            return max(float((a - ref_a).abs().max() / ref_a.abs().max()),
                       float((b - ref_b).abs().max() / ref_b.abs().max()))

        e_k = err(H.double(), g_.double(), Hd, gd)
        e_p = err(Hp.double(), gp.double(), Hd, gd)
        assert e_k <= max(2e-4, 2.0 * e_p), (mode, e_k, e_p)


@pytest.mark.parametrize("n_ref", [131072, 98304])
def test_knn_kernel_at_submap_shapes(dev, n_ref):
    """The back end's targets: a submap's geometric surf cloud (131072)
    and the semantic registration's 3 x 32768 class clouds, queried by the
    8192-point matched cloud at the cache's k and cap: bit-equal."""
    q, ref, mask = _clouds(dev, 8192, n_ref, seed=3)
    d, i, xyz = knn_cuda.knn(q, ref, mask, k=8, max_sq_dist=4.0)
    dp, ip, xp = knn_cuda.knn_plain(q, ref, mask, k=8, max_sq_dist=4.0)
    torch.cuda.synchronize()
    assert torch.equal(d, dp) and torch.equal(i, ip)
    assert torch.equal(xyz, xp)
    assert int(torch.isfinite(d).sum()) > 0


@pytest.mark.parametrize("empty", [False, True])
def test_knn_kernel_k1_dynamic_removal(dev, empty):
    """k=1 without a cap, as mapping/submap.dynamic_removal_mask calls it:
    a map with holes, and an empty map, which must give +inf (the
    new-structure branch), never a finite distance."""
    q, ref, mask = _clouds(dev, 8192, 65536, seed=4)
    if empty:
        mask = torch.zeros_like(mask)
    d, i, _ = knn_cuda.knn(q, ref, mask, k=1)
    dp, ip, _ = knn_cuda.knn_plain(q, ref, mask, k=1)
    torch.cuda.synchronize()
    assert torch.equal(d, dp) and torch.equal(i, ip)
    if empty:
        assert bool(torch.isinf(d).all()) and bool((i == -1).all())
    else:
        assert bool(torch.isfinite(d).all())


def test_gn_kernel_weighted_at_refine_shape(dev):
    """Non-unit semantic weights in [0.5, 2] at Q 8192 (the refinement's
    matched surf capacity): scaled atol 2e-4 against the plain version."""
    r = np.random.default_rng(6)
    n_q, k = 8192, 8
    base = r.uniform(-30, 30, (n_q, 1, 3))
    cand = base + np.stack([r.uniform(-0.5, 0.5, (n_q, k)),
                            r.uniform(-0.5, 0.5, (n_q, k)),
                            r.normal(0, 0.005, (n_q, k))], -1)
    pose = torch.tensor([0.01, -0.02, 0.05, 0.3, -0.2, 0.04], device=dev)
    world = torch.from_numpy((base[:, 0] + r.normal(0, 0.05, (n_q, 3)))
                             .astype(np.float32)).to(dev)
    pts = se3.transform_points(se3.transform_inverse(se3.pose_to_matrix(
        pose)), world).contiguous()
    args = (pts, torch.from_numpy(r.uniform(size=n_q) > 0.1).to(dev),
            torch.from_numpy(cand.astype(np.float32)).to(dev),
            torch.from_numpy(r.uniform(size=(n_q, k)) > 0.1).to(dev),
            torch.from_numpy(r.uniform(0.5, 2.0, n_q).astype(np.float32))
            .to(dev),
            gn_cuda.pack_scalars(pose, SlamConfig().matching, "surf"))
    H, g, nv = gn_cuda.gn_partials(*args, "surf", k)
    Hp, gp, nvp = gn_cuda.gn_partials_plain(*args, "surf", k)
    torch.cuda.synchronize()
    assert int(nvp) > 1000 and int(nv) == int(nvp)
    for a, b in ((H, Hp), (g, gp)):
        scale = float(b.abs().max()) + 1e-9
        torch.testing.assert_close(a / scale, b / scale, atol=2e-4, rtol=0)


def _ragged_lanes(dev, sizes, n_refs, seed=7):
    """Lanes of different sizes, padded to the largest: queries with
    zeros, maps with masked-out points at the end."""
    r = np.random.default_rng(seed)
    q_max, n_max = max(sizes), max(n_refs)
    q = np.zeros((len(sizes), q_max, 3), np.float32)
    ref = np.zeros((len(sizes), n_max, 3), np.float32)
    mask = np.zeros((len(sizes), n_max), bool)
    for b, (qn, nn) in enumerate(zip(sizes, n_refs)):
        q[b, :qn] = r.uniform(-10, 10, (qn, 3))
        ref[b, :nn] = r.uniform(-10, 10, (nn, 3))
        mask[b, :nn] = r.uniform(size=nn) > 0.2
    return (torch.from_numpy(q).to(dev), torch.from_numpy(ref).to(dev),
            torch.from_numpy(mask).to(dev))


_LANE_SIZES = {1: ([700], [5000]), 3: ([700, 1024, 33], [5000, 16384, 129]),
               8: ([700, 1024, 33, 1, 512, 999, 64, 1000],
                   [5000, 16384, 129, 3000, 16384, 7, 128, 9999])}


@pytest.mark.parametrize("lanes", [1, 3, 8])
@pytest.mark.parametrize("k,cap", [(8, 4.0), (1, None)])
def test_knn_kernel_lanes_bit_equal(dev, lanes, k, cap):
    """K1 over lanes of different sizes (padded): one launch, and each
    lane's rows bit-equal to a one-lane launch on the unpadded lane and to
    the plain version."""
    sizes, n_refs = _LANE_SIZES[lanes]
    q, ref, mask = _ragged_lanes(dev, sizes, n_refs)
    before = knn_cuda.knn.launches
    d, i, xyz = knn_cuda.knn_lanes(q, ref, mask, k=k, max_sq_dist=cap)
    assert knn_cuda.knn.launches == before + 1
    for b, (qn, nn) in enumerate(zip(sizes, n_refs)):
        args = (q[b, :qn].contiguous(), ref[b, :nn].contiguous(),
                mask[b, :nn].contiguous())
        d1, i1, x1 = knn_cuda.knn(*args, k=k, max_sq_dist=cap)
        dp, ip, _ = knn_cuda.knn_plain(*args, k=k, max_sq_dist=cap)
        torch.cuda.synchronize()
        assert torch.equal(d[b, :qn], d1) and torch.equal(i[b, :qn], i1)
        assert torch.equal(xyz[b, :qn], x1)
        assert torch.equal(d1, dp) and torch.equal(i1, ip)
    done, total = knn_cuda.tiles_computed(q, ref, mask, k=k, max_sq_dist=cap)
    assert 0 <= done <= total


@pytest.mark.parametrize("lanes", [1, 3, 8])
def test_gn_kernel_lanes_bit_equal(dev, lanes):
    """K2 over lanes of different sizes (padded with masked-out queries),
    scalar rows from device memory, rows and sums in float64: one launch,
    each lane bit-equal to a one-lane launch on the unpadded lane, with
    n_valid equal to and H, g within 1e-6 scaled of the float64 plain
    version, and n_valid equal to the float32 one-lane launch's."""
    k, cfg = 8, SlamConfig().matching
    sizes = _LANE_SIZES[lanes][0]
    r = np.random.default_rng(11)
    clouds, poses = [], []
    for b, qn in enumerate(sizes):
        c = _gn_cloud(dev, "corner", qn, k, seed=20 + b)
        s_ = _gn_cloud(dev, "surf", 2 * qn, k, seed=40 + b)
        clouds.append((c, s_))
        poses.append(torch.tensor(_GN_POSE) + torch.from_numpy(
            r.normal(0, 0.01, 6).astype(np.float32)))

    def pad(ts, n):
        out = torch.zeros((len(ts), n) + ts[0].shape[1:], dtype=ts[0].dtype,
                          device=dev)
        for b, t in enumerate(ts):
            out[b, :t.shape[0]] = t
        return out

    lanes_args = []
    for j in (0, 1):
        n = max(c[j][0].shape[0] for c in clouds)
        lanes_args.append([pad([c[j][f] for c in clouds], n)
                           for f in range(5)])
    rows = torch.stack([gn_cuda.scalar_rows(p, cfg) for p in poses]).to(dev)
    before = gn_cuda.gn_iteration_vec.launches
    hg = gn_cuda.gn_iteration_lanes(rows, *lanes_args[0][:4],
                                    *lanes_args[1][:4], lanes_args[0][4],
                                    lanes_args[1][4], k)
    assert gn_cuda.gn_iteration_vec.launches == before + 1
    for b, (c, s_) in enumerate(clouds):
        lane = (rows[b:b + 1], *(t[None] for t in c[:4]),
                *(t[None] for t in s_[:4]), c[4][None], s_[4][None], k)
        one = gn_cuda.gn_iteration_lanes(*lane)[0]
        ref = gn_cuda.gn_iteration_lanes_plain(*lane)[0]
        vec = gn_cuda.gn_iteration_vec(poses[b], *c[:4], *s_[:4], c[4],
                                       s_[4], cfg, k)
        torch.cuda.synchronize()
        assert torch.equal(hg[b], one), b
        assert int(one[42]) == int(ref[42]) == int(vec[42]) > 0
        for a_, r_ in ((one[:36], ref[:36]), (one[36:42], ref[36:42])):
            scale = float(r_.abs().max()) + 1e-9
            torch.testing.assert_close(a_ / scale, r_ / scale, rtol=0,
                                       atol=1e-6)


def _k3_lanes(b, seed=5):
    """Packed normal equations (b, 43) and start poses for K3, lane i of
    kind (i + 4) % 5: 0 well conditioned, 1 degenerate (one direction
    1e-3 as stiff), 2 converged before the call (frozen), 3 under
    min_valid_points, 4 an eigenvalue 5e-4 relative above the degeneracy
    threshold and one 5e-4 below it (B = 1 is that lane)."""
    r = np.random.default_rng(seed)
    hg, kinds = [], [(i + 4) % 5 for i in range(b)]
    for kind in kinds:
        J = r.normal(0, 1, (300, 6)) * np.float64([3, 3, 3, 20, 20, 20])
        if kind == 1:
            J[:, 5] *= 1e-3
        H = J.T @ J
        if kind == 4:
            Qm, _ = np.linalg.qr(r.normal(size=(6, 6)))
            e = np.float64([100 * (1 - 5e-4), 100 * (1 + 5e-4), 900, 3e3,
                            2e4, 9e4])
            H = (Qm * e) @ Qm.T
        g = r.normal(0, 5e-3 if kind % 2 else 50, 6)
        hg.append(np.concatenate([H.reshape(-1), g,
                                  [30 if kind == 3 else 300]]))
    pose0 = r.normal(0, 0.1, (b, 6))
    return (np.stack(hg).astype(np.float32), pose0.astype(np.float32),
            np.asarray(kinds))


@pytest.mark.parametrize("lanes", [1, 3, 8, 32])
def test_gn_solve_kernel_matches_plain(dev, lanes):
    """K3 against its plain version at B = 1, 3, 8 and 32 (ragged blocks
    of 4 lanes): flags and `it` equal, pose within 1e-5, proj within 1e-4,
    scalar rows within 1e-5, on lanes well conditioned, degenerate,
    frozen (converged before the call), under min_valid_points and with
    eigenvalues within 1e-3 relative of the threshold; the rows-only
    launch (solve = 0) equals the plain rows."""
    from lis_slam_torch.ops import gn_solve

    cfg = SlamConfig().matching
    hg, pose0, kinds = _k3_lanes(lanes)
    hg = torch.from_numpy(hg).to(dev)
    st = gn_solve.init_state(torch.from_numpy(pose0).to(dev))
    frozen = torch.from_numpy(kinds == 2).to(dev)
    st = st._replace(converged=frozen, it=torch.full(
        (lanes,), 2, dtype=torch.int32, device=dev))
    before = gn_solve.solve.launches
    new, rows = gn_solve.solve(hg, st, cfg)
    ref, ref_rows = gn_solve.solve_plain(hg, st, cfg)
    torch.cuda.synchronize()
    assert gn_solve.solve.launches == before + 1
    for f in ("degenerate", "converged", "n_valid", "it"):
        assert torch.equal(getattr(new, f), getattr(ref, f)), f
    torch.testing.assert_close(new.pose, ref.pose, rtol=0, atol=1e-5)
    torch.testing.assert_close(new.proj, ref.proj, rtol=0, atol=1e-4)
    torch.testing.assert_close(rows, ref_rows, rtol=0, atol=1e-5)
    for f in ("delta_r", "delta_t"):
        torch.testing.assert_close(getattr(new, f), getattr(ref, f),
                                   rtol=1e-4, atol=1e-6)
    for i, kind in enumerate(kinds.tolist()):
        if kind in (1, 4):  # an eigenvalue under the threshold
            assert bool(new.degenerate[i]), i
        if kind == 2:  # frozen: the state passes through, it not counted
            assert torch.equal(new.pose[i], st.pose[i]) and int(new.it[i]) == 2
        else:
            assert int(new.it[i]) == 3, i
        if kind == 3:  # too few rows: no step, converged
            assert bool(new.converged[i]) and torch.equal(new.pose[i],
                                                          st.pose[i])
    before = gn_solve.solve.launches
    only_rows = gn_solve.scalar_rows(new, cfg)
    assert gn_solve.solve.launches == before + 1
    torch.testing.assert_close(only_rows,
                               gn_solve.scalar_rows_plain(new.pose, cfg),
                               rtol=0, atol=1e-5)
