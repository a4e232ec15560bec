"""The PyTorch port's copies of the JAX package's host-side modules.

The port cannot import lis_slam_tpu (its package __init__ imports JAX, and
the GPU machine has none), so config.py, labels.py, io/synthetic.py,
utils/se3_np.py, pipeline/navsat.py, io/kitti.py and viz/debug.py are
copied into lis_slam_torch/, and so is the RangeNet
checkpoint weights/rangenet_synthetic_slim.npz (the port reads no file of
the JAX package). These tests pin the copies to the originals.
"""

import dataclasses
import hashlib
import os
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")

import lis_slam_tpu
import lis_slam_torch
from lis_slam_tpu import config as jcfg, labels as jlabels
from lis_slam_tpu.io import synthetic as jsyn
from lis_slam_torch import config as tcfg, labels as tlabels
from lis_slam_torch.io import synthetic as tsyn

_COPIES = ["config.py", "labels.py", "io/synthetic.py", "utils/se3_np.py",
           "weights/rangenet_synthetic_slim.npz", "pipeline/navsat.py",
           "io/kitti.py", "viz/debug.py"]
CHECKPOINT_SHA256 = (
    "1306bde1bb466a8c6e25331ba48d3cf997552b9b7d19738813f4a1f11b0d3336")


@pytest.mark.parametrize("rel", _COPIES)
def test_copy_is_verbatim(rel):
    a = Path(lis_slam_tpu.__file__).parent / rel
    b = Path(lis_slam_torch.__file__).parent / rel
    assert a.read_bytes() == b.read_bytes(), f"{rel} drifted from the original"


@pytest.mark.parametrize("preset", sorted(jcfg.PRESETS))
def test_config_presets_equal(preset):
    assert (dataclasses.asdict(jcfg.PRESETS[preset]())
            == dataclasses.asdict(tcfg.PRESETS[preset]()))


def test_default_config_equal():
    assert dataclasses.asdict(jcfg.SlamConfig()) == dataclasses.asdict(
        tcfg.SlamConfig())


def test_label_tables_equal():
    for name in dir(jlabels):
        v = getattr(jlabels, name)
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(v, getattr(tlabels, name),
                                          err_msg=name)
        elif isinstance(v, (tuple, int, float, str, dict)) and \
                not name.startswith("__"):
            assert v == getattr(tlabels, name), name


def test_render_scan_bitwise_equal():
    world_j = jsyn.make_world(seed=3)
    world_t = tsyn.make_world(seed=3)
    np.testing.assert_array_equal(world_j.boxes, world_t.boxes)
    pose = jsyn.circular_trajectory(3)[1]
    nxt = jsyn.circular_trajectory(3)[2]
    a = jsyn.render_scan(world_j, pose, nxt, horizon=180, seed=11)
    b = tsyn.render_scan(world_t, pose, nxt, horizon=180, seed=11)
    for f in ("points", "labels", "times", "valid", "gyro", "accel",
              "imu_time"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                      err_msg=f)


def test_checkpoint_copy_hash():
    """The port's default checkpoint is its own file, with the hash of the
    JAX package's."""
    from lis_slam_torch.semantic import weights as W

    path = os.path.realpath(W.DEFAULT_CHECKPOINT)
    assert path.startswith(os.path.realpath(
        Path(lis_slam_torch.__file__).parent) + os.sep)
    for p in (path, Path(lis_slam_tpu.__file__).parent
              / "weights/rangenet_synthetic_slim.npz"):
        with open(p, "rb") as f:
            assert hashlib.sha256(f.read()).hexdigest() == CHECKPOINT_SHA256
