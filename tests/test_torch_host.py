"""The PyTorch port's copies of the JAX package's host-side modules.

The port cannot import lis_slam_tpu (its package __init__ imports JAX, and
the GPU machine has none), so config.py, labels.py, io/synthetic.py,
utils/se3_np.py, pipeline/navsat.py, io/kitti.py, viz/debug.py and
golden/replica.py are copied into lis_slam_torch/, and so are the RangeNet
checkpoint weights/rangenet_synthetic_slim.npz and the native host
runtime's source (native/lis_host.cpp as csrc/host/lis_host.cpp): the port
reads no file of the JAX package. These tests pin the copies to the
originals (config.py less the port's own key, `PORT_ONLY`, which at its
default leaves every configuration the JAX package's), and hold that nothing of the port imports JAX or the JAX
package. The port's StageTimer prints what the JAX one prints.
"""

import ast
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
           "io/kitti.py", "viz/debug.py", "golden/replica.py"]
_REPO = Path(lis_slam_torch.__file__).parent.parent
CHECKPOINT_SHA256 = (
    "1306bde1bb466a8c6e25331ba48d3cf997552b9b7d19738813f4a1f11b0d3336")
# the port's own additions to a copy, each present exactly once: the copy
# less these lines is the original byte for byte
PORT_ONLY = {"config.py": (
    b"    # the port's own key, not in lis_slam_tpu/config.py: keyframes "
    b"labelled\n"
    b"    # on the net's own model_input_h x model_input_w projection of "
    b"the\n"
    b"    # pretreated scan (netTensorRT's doProjection input) instead of "
    b"the\n"
    b"    # front end's range image (semantic/inference.py)\n"
    b"    own_projection: bool = False\n")}
# the port's own configuration keys (section, key): at their defaults a
# configuration is the JAX package's
PORT_ONLY_KEYS = (("semantic", "own_projection"),)


def without_port_keys(cfg) -> dict:
    """dataclasses.asdict of a port SlamConfig without PORT_ONLY_KEYS,
    which must hold their defaults."""
    d = dataclasses.asdict(cfg)
    for section, key in PORT_ONLY_KEYS:
        assert d[section].pop(key) is False, (section, key)
    return d


@pytest.mark.parametrize("rel", _COPIES)
def test_copy_is_verbatim(rel):
    a = (Path(lis_slam_tpu.__file__).parent / rel).read_bytes()
    b = (Path(lis_slam_torch.__file__).parent / rel).read_bytes()
    extra = PORT_ONLY.get(rel)
    if extra is not None:
        assert b.count(extra) == 1, f"{rel} lost the port's own lines"
        b = b.replace(extra, b"")
    assert a == b, f"{rel} drifted from the original"


@pytest.mark.parametrize("preset", sorted(jcfg.PRESETS))
def test_config_presets_equal(preset):
    assert (dataclasses.asdict(jcfg.PRESETS[preset]())
            == without_port_keys(tcfg.PRESETS[preset]()))


def test_default_config_equal():
    assert dataclasses.asdict(jcfg.SlamConfig()) == without_port_keys(
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


def test_host_runtime_source_is_verbatim():
    a = _REPO / "native" / "lis_host.cpp"
    b = Path(lis_slam_torch.__file__).parent / "csrc" / "host" / "lis_host.cpp"
    assert a.read_bytes() == b.read_bytes(), "lis_host.cpp drifted"


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_no_jax():
    """No module of lis_slam_torch/ (run_kitti.py and train/recipe.py
    included), not chip_smoke.py, not the recipe's CLI
    scripts/train_rangenet_synthetic_torch.py and not
    scripts/cpu_bf16_conv_check.py imports jax, flax, optax or
    lis_slam_tpu."""
    pkg = Path(lis_slam_torch.__file__).parent
    files = sorted(pkg.rglob("*.py"))
    files += [_REPO / "chip_smoke.py",
              _REPO / "scripts" / "train_rangenet_synthetic_torch.py",
              _REPO / "scripts" / "cpu_bf16_conv_check.py"]
    assert any(f.name == "run_kitti.py" for f in files)
    assert pkg / "train" / "recipe.py" in files
    assert all(f.is_file() for f in files)
    banned = ("jax", "jaxlib", "flax", "optax", "lis_slam_tpu")
    for f in files:
        for mod in _imported_modules(f):
            assert mod.split(".")[0] not in banned, f"{f}: imports {mod}"


def test_stage_timer_summary_matches_jax():
    from lis_slam_tpu.utils import profiling as jprof
    from lis_slam_torch.utils import profiling as tprof

    logs = {"jax": [], "port": []}
    timers = {"jax": jprof.StageTimer(log_every=2, log_fn=logs["jax"].append),
              "port": tprof.StageTimer(log_every=2,
                                       log_fn=logs["port"].append)}
    stats = {"scan": (5, 0.0625, 0.0125), "drain": (17, 0.502, 0.5),
             "a_very_long_stage_name_past_thirty": (1, 2.5, 2.5)}
    for t in timers.values():
        for name in ("scan", "scan", "drain",
                     "a_very_long_stage_name_past_thirty"):
            with t.stage(name):
                pass
        for name, (count, total, worst) in stats.items():
            s = t.stats[name]
            s.count, s.total_s, s.max_s = count, total, worst
    assert timers["port"].summary() == timers["jax"].summary()
    assert [m.split(" time")[0] for m in logs["port"]] == \
        [m.split(" time")[0] for m in logs["jax"]] == ["Average scan"]
    assert "total_ms" in timers["port"].report()["scan"]
