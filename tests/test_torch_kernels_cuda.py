"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card. Every test here is marked `cuda` and skips without a GPU; the
file imports no JAX, so it runs where only the port is installed:

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda --noconftest

(`--noconftest`: tests/conftest.py sets up JAX for the rest of the suite.)

Kernels: K1 exact kNN (ops/knn_cuda.py, csrc/knn.cu) and K2 fused GN
accumulation (ops/gn_cuda.py, csrc/gn.cu). chip_smoke.py runs the same
comparisons at the front end's full shapes.
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
    assert torch.equal(torch.isinf(d), torch.isinf(dp))
    assert torch.equal(i < 0, torch.isinf(d))
    fin = torch.isfinite(dp)
    torch.testing.assert_close(d[fin], dp[fin], rtol=1e-5, atol=0)
    off = i != ip  # only between exactly tied distances
    assert torch.equal(d[off], dp[off])
    near = torch.where((i >= 0)[..., None], ref[i.clamp(min=0).long()], 0.0)
    assert torch.equal(near, xyz)


def test_knn_kernel_rejects_unbuilt_k(dev):
    q, ref, mask = _clouds(dev, 64, 256)
    with pytest.raises(ValueError):
        knn_cuda.knn(q, ref, mask, k=7)
    with pytest.raises(ValueError):
        knn_cuda.knn(q.t().contiguous().t(), ref, mask, k=8)


@pytest.mark.parametrize("mode", ["corner", "surf"])
def test_gn_kernel_matches_plain(dev, mode):
    """Well-conditioned fits (random spreads, not collinear neighbours):
    H and g to atol 2e-4 after scaling, as tests/test_pallas_gn.py."""
    r = np.random.default_rng(1)
    n_q, k = 1000, 8
    if mode == "corner":  # candidates along vertical lines
        base = r.uniform(-20, 20, (n_q, 1, 3))
        cand = base + np.stack([r.normal(0, 0.01, (n_q, k)),
                                r.normal(0, 0.01, (n_q, k)),
                                r.uniform(-0.5, 0.5, (n_q, k))], -1)
    else:  # candidates on horizontal patches
        base = r.uniform(-20, 20, (n_q, 1, 3))
        cand = base + np.stack([r.uniform(-0.5, 0.5, (n_q, k)),
                                r.uniform(-0.5, 0.5, (n_q, k)),
                                r.normal(0, 0.005, (n_q, k))], -1)
    pose = torch.tensor([0.01, -0.02, 0.05, 0.3, -0.2, 0.04], device=dev)
    T_inv = se3.transform_inverse(se3.pose_to_matrix(pose))
    world = torch.from_numpy((base[:, 0] + r.normal(0, 0.05, (n_q, 3)))
                             .astype(np.float32)).to(dev)
    pts = se3.transform_points(T_inv, world).contiguous()
    args = (pts, torch.from_numpy(r.uniform(size=n_q) > 0.1).to(dev),
            torch.from_numpy(cand.astype(np.float32)).to(dev),
            torch.from_numpy(r.uniform(size=(n_q, k)) > 0.1).to(dev),
            torch.from_numpy(r.uniform(0.5, 1.5, n_q).astype(np.float32))
            .to(dev),
            gn_cuda.pack_scalars(pose, SlamConfig().matching, mode))
    before = gn_cuda.gn_partials.launches
    H, g, nv = gn_cuda.gn_partials(*args, mode, k)
    H2, g2, _ = gn_cuda.gn_partials(*args, mode, k)
    Hp, gp, nvp = gn_cuda.gn_partials_plain(*args, mode, k)
    torch.cuda.synchronize()
    assert gn_cuda.gn_partials.launches == before + 2
    assert torch.equal(H, H2) and torch.equal(g, g2)  # no atomics
    assert int(nvp) > 100 and int(nv) == int(nvp)
    for a, b in ((H, Hp), (g, gp)):
        scale = float(b.abs().max()) + 1e-9
        torch.testing.assert_close(a / scale, b / scale, atol=2e-4, rtol=0)


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
        assert torch.equal(torch.isinf(d), torch.isinf(dp))
        fin = torch.isfinite(dp)
        assert int(fin.sum()) > 0 and torch.equal(d[fin], dp[fin])
        off = i != ip
        assert torch.equal(d[off], dp[off])
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
