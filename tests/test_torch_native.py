"""The port's native host runtime (lis_slam_torch/runtime/native.py over
csrc/host/lis_host.cpp, built here with the host compiler) against the
JAX package's runtime.native on the same fake KITTI files: read_bin,
range_filter, voxel_filter and AsyncScanLoader bit-equal, and the numpy
fallback equal to the native reader."""

import os

import numpy as np
import pytest

pytest.importorskip("jax")

from lis_slam_tpu.runtime import native as jnative
from lis_slam_torch.runtime import native


@pytest.fixture
def fake_kitti(tmp_path):
    """Six scans of ragged sizes, with a NaN row, near and far points."""
    rng = np.random.default_rng(0)
    velo = tmp_path / "sequences" / "00" / "velodyne"
    velo.mkdir(parents=True)
    scans = []
    for i in range(6):
        pts = rng.uniform(-60, 60, (900 + 137 * i, 4)).astype(np.float32)
        pts[5] = np.nan
        pts[7, :3] = 0.0005
        pts.tofile(velo / f"{i:06d}.bin")
        scans.append(pts)
    files = sorted(str(velo / f) for f in os.listdir(velo))
    return files, scans


def test_native_builds_into_the_package():
    assert native.available()
    assert native.lib_path().exists()
    assert native.lib_path().parent == native.BUILD_DIR


def test_read_bin_equal(fake_kitti):
    files, scans = fake_kitti
    for f, s in zip(files, scans):
        a = native.read_bin(f, 2000)
        np.testing.assert_array_equal(a, jnative.read_bin(f, 2000))
        np.testing.assert_array_equal(a, s)
    # capped below the file's size
    np.testing.assert_array_equal(native.read_bin(files[3], 500),
                                  jnative.read_bin(files[3], 500))
    with pytest.raises(FileNotFoundError):
        native.read_bin(files[0] + ".missing", 10)


def test_fallback_read_bin_matches_native(fake_kitti, monkeypatch):
    files, _ = fake_kitti
    nat = [native.read_bin(f, 1200) for f in files]
    monkeypatch.setattr(native, "_load", lambda: None)
    assert not native.available()
    for f, a in zip(files, nat):
        np.testing.assert_array_equal(native.read_bin(f, 1200), a)


@pytest.mark.parametrize("lo,hi", [(0.0, 1e9), (5.0, 40.0), (1.0, 70.0)])
def test_range_filter_equal(fake_kitti, lo, hi):
    _, scans = fake_kitti
    for s in scans:
        a = native.range_filter(s.copy(), lo, hi)
        np.testing.assert_array_equal(a, jnative.range_filter(s.copy(), lo,
                                                              hi))
        r = np.linalg.norm(a[:, :3], axis=1)
        assert np.isfinite(a).all()
        assert (r >= lo - 1e-3).all() and (r <= hi + 1e-3).all()


@pytest.mark.parametrize("leaf", [0.5, 2.0])
def test_voxel_filter_equal(leaf):
    pts = np.random.default_rng(2).uniform(-4, 4, (5000, 3)).astype(
        np.float32)
    a = native.voxel_filter(pts, leaf)
    np.testing.assert_array_equal(a, jnative.voxel_filter(pts, leaf))
    cells = {tuple(c) for c in np.floor(a / leaf).astype(np.int64)}
    assert len(cells) == len(a)


@pytest.mark.parametrize("gate", [(0.0, 1e9), (2.0, 50.0)])
def test_async_loader_equal(fake_kitti, gate):
    files, _ = fake_kitti
    kw = dict(max_points=1200, capacity=2, n_threads=3, min_range=gate[0],
              max_range=gate[1])
    ours = native.AsyncScanLoader(files, **kw)
    theirs = jnative.AsyncScanLoader(files, **kw)
    a, b = list(ours), list(theirs)
    ours.close()
    theirs.close()
    assert len(a) == len(b) == len(files)
    for (ba, na), (bb, nb) in zip(a, b):
        assert na == nb
        np.testing.assert_array_equal(ba, bb)
        assert not ba[na:].any()  # zero padding past the count


def test_fallback_loader_reads_in_order(fake_kitti, monkeypatch):
    """Without the library the loader reads synchronously and, as the JAX
    module's fallback does, ignores the range gate."""
    files, scans = fake_kitti
    monkeypatch.setattr(native, "_load", lambda: None)
    got = list(native.AsyncScanLoader(files, max_points=2000,
                                      min_range=5.0, max_range=10.0))
    assert [n for _b, n in got] == [len(s) for s in scans]
    for (buf, n), s in zip(got, scans):
        np.testing.assert_array_equal(buf[:n], s)
