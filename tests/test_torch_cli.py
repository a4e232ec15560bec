"""The port's KITTI-replay CLI (lis_slam_torch/run_kitti.py) against the
JAX package on the same fake KITTI sequence: 16-beam plaza renders
(tests/_torch_plaza.py) written in KITTI layout.

- replay_kitti(device="cpu") at the tiny_cfgs size against the JAX
  SemanticSlam fed as examples/run_kitti.py feeds it (the JAX native
  loader with the same range gate, driver.pad_scan, no labels): raw and
  corrected ATE <= 1.5 x the JAX run's + 0.02 m and submaps within +-1
  (tests/test_torch_slam.py's tolerances).
- main([...]) with the kitti preset on the host: pred.txt (N, 12), the
  PCD map read back, the native loader and ATE lines printed.
- The host pose conversion the CLI evaluates with (utils/se3_np) against
  the JAX se3.matrix_to_pose on the ground-truth poses, and the
  pinned-copy upload keeping every field of the scan.
"""

import os

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp
import torch

from lis_slam_tpu.pipeline import driver as jdriver, slam as jslam
from lis_slam_tpu.pipeline import trajectory as jtraj
from lis_slam_tpu.runtime import native as jnative
from lis_slam_tpu.utils import se3 as jse3
from lis_slam_torch import run_kitti
from lis_slam_torch.io import kitti
from lis_slam_torch.pipeline import driver, trajectory

from _torch_plaza import render_plaza, tiny_cfgs

N = 12


@pytest.fixture(scope="module")
def fake_kitti(tmp_path_factory):
    scans, gt = render_plaza(N)
    root = str(tmp_path_factory.mktemp("kitti"))
    run_kitti.write_sequence(root, "00", [s.points[s.valid] for s in scans],
                             gt[:N])
    return root, scans, gt[:N]


def test_sequence_layout(fake_kitti):
    root, scans, gt = fake_kitti
    seq = kitti.KittiSequence(root, "00")
    assert len(seq) == N
    np.testing.assert_array_equal(seq.scan(3), scans[3].points[scans[3].valid])
    g = seq.ground_truth()
    assert g.shape == (N, 4, 4)
    np.testing.assert_allclose(run_kitti.ground_truth6(root, "00", N),
                               trajectory.relative_to_first(gt), atol=1e-6)


def test_replay_matches_jax(fake_kitti):
    root, _scans, gt = fake_kitti
    jcfg, tcfg = tiny_cfgs()
    system, tres = run_kitti.replay_kitti(tcfg, root, "00", device="cpu")
    # the JAX CLI's path: native loader (same gate) -> pad_scan
    seq = kitti.KittiSequence(root, "00")
    files = [os.path.join(seq.velo_dir, f) for f in seq.files]
    js = jslam.SemanticSlam(jcfg)
    loader = jnative.AsyncScanLoader(
        files, max_points=jcfg.sensor.max_raw_points,
        min_range=jcfg.sensor.lidar_min_range,
        max_range=jcfg.sensor.lidar_max_range)
    for buf, count in loader:
        js.process_scan(jdriver.pad_scan(buf[:count], jcfg))
    loader.close()
    jres = js.finish()
    gt_rel = trajectory.relative_to_first(gt)
    assert tres.poses.shape == (N, 6) and np.isfinite(tres.poses).all()
    assert abs(tres.n_submaps - jres.n_submaps) <= 1
    for f in ("raw_poses", "poses"):
        a = trajectory.ate_rmse(getattr(tres, f), gt_rel, align=True)
        j = jtraj.ate_rmse(getattr(jres, f), gt_rel, align=True)
        assert a <= 1.5 * j + 0.02, (f, a, j)
    assert system.model is None  # the kitti-size config: no semantics


def test_main_writes_trajectory_and_map(fake_kitti, tmp_path, capsys):
    root, _scans, _gt = fake_kitti
    out, pcd = str(tmp_path / "pred.txt"), str(tmp_path / "map.pcd")
    system, res, timer = run_kitti.main([
        "--root", root, "--sequence", "00", "--out", out, "--max-scans", "3",
        "--save-map", pcd, "--gn-backend", "pallas", "--cpu"])
    printed = capsys.readouterr().out
    assert "native loader: True" in printed and "ATE " in printed
    assert system.cfg.matching.gn_backend == "pallas"
    assert timer.stats["scan"].count == 3
    pred = np.loadtxt(out)
    assert pred.shape == (3, 12)
    cloud = kitti.read_pcd(pcd)
    assert cloud.shape == (len(res.global_map), 4)
    np.testing.assert_allclose(cloud[:, :3], res.global_map[:, :3],
                               atol=1e-4)


def test_host_pose_conversion_matches_jax(fake_kitti):
    root, _scans, _gt = fake_kitti
    g = kitti.KittiSequence(root, "00").ground_truth()
    want = np.asarray(jse3.matrix_to_pose(jnp.asarray(g, jnp.float32)))
    got = np.stack([run_kitti.se3_np.matrix_to_pose(T) for T in g])
    np.testing.assert_allclose(got, want, atol=2e-6)


def test_upload_keeps_the_scan():
    _, tcfg = tiny_cfgs()
    pts = np.random.default_rng(0).normal(size=(500, 4)).astype(np.float32)
    sin = driver.pad_scan(pts, tcfg)
    # on the host the upload is the identity; the card path is exercised
    # by chip_smoke.py's cli phase
    assert run_kitti.upload_scan(sin, 500, torch.device("cpu")) is sin
    assert int(sin.valid.sum()) == 500
