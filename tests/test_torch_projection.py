"""Port parity of the unfused projection pair (lis_slam_torch/ops/
projection.py `project`, `extract`) and of the RangeNet recipe's
`make_image` (lis_slam_torch/train/recipe.py) against the JAX package, on
one rendered 64 x 1800 HDL-64 scan at SlamConfig().sensor (rings
downsampled by 2), the numpy renderer's, fed to both.

- `project` and `extract` are bit-equal to JAX's jitted CPU program in
  every field; `extract`'s `src` is all -1.
- The column is rounded as that program rounds it (a product with the
  float32 reciprocal of the angular resolution after one fused
  multiply-add); this scan holds points that the plain expression puts
  one column over.
- Nearest range wins (tests/test_frontend_ops.py's case). Among winners
  of EQUAL range the highest raw index wins: the rule JAX's CPU program
  follows (its colliding scatter-set keeps the last write), which the port
  keeps with no colliding write.
- The port's fused project_and_extract against the port's pair meets the
  JAX package's own bar for its pair (tests/test_frontend_ops.py:287-307):
  equal masks, counts and columns, ranges within 0.02 m.
- recipe.make_image is bit-equal to the body of the JAX script's
  make_image (scripts/train_rangenet_synthetic.py:46-57), jitted here:
  images, labels and masks.
"""

import math

import numpy as np
import pytest

pytest.importorskip("jax")

import jax
import jax.numpy as jnp
import torch

from lis_slam_tpu.config import SlamConfig as JSlamConfig
from lis_slam_tpu.config import slim_semantic_config as jslim
from lis_slam_tpu.io import synthetic
from lis_slam_tpu.models import rangenet as jrn
from lis_slam_tpu.ops import pretreatment as jpre, projection as jproj
from lis_slam_torch.config import SlamConfig, slim_semantic_config
from lis_slam_torch.ops import projection as tproj
from lis_slam_torch.train import recipe

FUSED_RNG_ATOL = 0.02  # m, tests/test_frontend_ops.py:300


def _t(x):
    return torch.from_numpy(np.array(x))


def _fields_equal(t, j):
    for f in j._fields:
        np.testing.assert_array_equal(getattr(t, f).numpy(),
                                      np.asarray(getattr(j, f)), err_msg=f)


@pytest.fixture(scope="module")
def scan():
    """(points (P, 4), labels (P,), valid (P,)) of a circuit scan."""
    world = synthetic.make_world(seed=5)
    gt = synthetic.circular_trajectory(8, radius=60.0, speed=8.0)
    s = synthetic.render_scan(world, gt[5], None, seed=75)
    return s.points.astype(np.float32), s.labels.astype(np.int32), s.valid


@pytest.fixture(scope="module")
def jax_pair(scan):
    """The pretreated scan's project() inputs (labels in rel_time, as the
    recipe carries them) and JAX's image and extracted cloud."""
    cfg = JSlamConfig().sensor
    pts, lab, valid = scan
    pre = jpre.pretreat(jnp.asarray(pts), jnp.asarray(valid), cfg)
    args = tuple(np.asarray(a) for a in (
        pre.points[:, :3], pre.points[:, 3], pre.ring, lab.astype(np.float32),
        pre.valid))
    img = jax.jit(jproj.project, static_argnums=5)(*args, cfg)
    return args, img, jax.jit(jproj.extract)(img)


def test_project_bit_equal(jax_pair):
    args, jimg, _ = jax_pair
    img = tproj.project(*(_t(a) for a in args), SlamConfig().sensor)
    _fields_equal(img, jimg)
    mask = img.mask.numpy()
    assert mask.sum() > 10000
    assert not mask[1::2].any()  # downsample_rate 2: odd rows empty
    # labels survive the rel_time channel
    assert set(np.unique(img.time.numpy()[mask])) <= set(range(20))


def test_pixel_columns_round_as_jax_cpu(jax_pair):
    """Columns of the scan's in-grid points equal the JAX program's, and
    the plain expression would move some of them."""
    args, _, _ = jax_pair
    pts = args[0]
    h = 1800

    @jax.jit
    def jcol(p):
        ang = jnp.arctan2(p[:, 0], p[:, 1]) * (180.0 / jnp.pi)
        col = (-jnp.round((ang - 90.0) / (360.0 / h))).astype(jnp.int32)
        return col + h // 2

    want = np.asarray(jcol(jnp.asarray(pts)))
    want = np.where(want >= h, want - h, want)
    got = tproj.pixel_columns(_t(pts), h).numpy()
    ok = args[4]
    np.testing.assert_array_equal(got[ok], want[ok])
    ang = torch.atan2(_t(pts[:, 0]), _t(pts[:, 1])) * (180.0 / math.pi)
    plain = (-torch.round((ang - 90.0) / (360.0 / h))).to(torch.int32)
    assert ((plain.numpy() + h // 2) % h != got)[ok].sum() > 0


def test_projection_nearest_wins():
    cfg = SlamConfig().sensor
    pts = torch.tensor([[10.0, 0.0, 0.0], [5.0, 0.0, 0.001]])
    img = tproj.project(pts, torch.tensor([1.0, 2.0]),
                        torch.zeros(2, dtype=torch.int32), torch.zeros(2),
                        torch.ones(2, dtype=torch.bool), cfg)
    mask = img.mask.numpy()
    assert mask.sum() == 1
    i, j = np.argwhere(mask)[0]
    assert np.isclose(img.rng[i, j].item(), 5.0, atol=1e-3)
    assert img.intensity[i, j].item() == 2.0


def test_equal_range_tie_keeps_highest_raw_index():
    """Several points of exactly equal range in one pixel, with nearer and
    farther points in their own and other pixels: the winner's payload is
    that of the highest raw index among the nearest, in JAX's CPU program
    and in the port."""
    r = np.random.default_rng(4)
    tie = np.array([5.0, 0.0, 0.0], np.float32)
    pts = np.concatenate([
        np.tile(tie, (7, 1)),  # the tied winners
        [[7.0, 0.0, 0.0], [6.0, 0.0, 0.0]],  # farther, same pixel
        np.tile([[0.0, 5.0, 0.0]], (3, 1)),  # a second tied pixel
        [[0.0, 4.0, 0.0]],  # ... with one nearer point
    ]).astype(np.float32)
    perm = r.permutation(len(pts))
    pts = pts[perm]
    inten = np.arange(len(pts), dtype=np.float32) + 1.0
    ring = np.zeros(len(pts), np.int32)
    rel = r.random(len(pts)).astype(np.float32)
    valid = np.ones(len(pts), bool)
    jimg = jax.jit(jproj.project, static_argnums=5)(
        pts, inten, ring, rel, valid, JSlamConfig().sensor)
    img = tproj.project(*(_t(a) for a in (pts, inten, ring, rel, valid)),
                        SlamConfig().sensor)
    _fields_equal(img, jimg)
    cols = tproj.pixel_columns(_t(pts), 1800).numpy()
    rng = np.linalg.norm(pts, axis=1)
    assert img.mask.sum() == 2
    for c in np.unique(cols):
        members = np.nonzero(cols == c)[0]
        nearest = members[rng[members] == rng[members].min()]
        want = nearest.max()
        assert img.intensity[0, c].item() == inten[want]
        assert img.time[0, c].item() == rel[want]
    # the first pixel's tie really has several candidates
    assert (np.all(pts == tie, axis=1)).sum() == 7


def test_extract_bit_equal(jax_pair):
    _, jimg, jext = jax_pair
    img = tproj.RangeImage(*(_t(a) for a in jimg))
    ext = tproj.extract(img)
    _fields_equal(ext, jext)
    assert (ext.src.numpy() == -1).all()
    np.testing.assert_array_equal(ext.count.numpy(),
                                  img.mask.numpy().sum(axis=1))


def test_fused_matches_pair_within_jax_bar(jax_pair):
    args, _, _ = jax_pair
    cfg = SlamConfig().sensor
    targs = tuple(_t(a) for a in args)
    img_a = tproj.project(*targs, cfg)
    ext_a = tproj.extract(img_a)
    img_b, ext_b = tproj.project_and_extract(*targs, cfg, want_image=True)
    ma = img_a.mask.numpy()
    np.testing.assert_array_equal(ma, img_b.mask.numpy())
    gap = np.abs(img_a.rng.numpy()[ma] - img_b.rng.numpy()[ma]).max()
    assert gap < FUSED_RNG_ATOL
    np.testing.assert_array_equal(ext_a.count.numpy(), ext_b.count.numpy())
    np.testing.assert_array_equal(ext_a.col.numpy(), ext_b.col.numpy())
    me = ext_a.mask.numpy()
    assert np.abs(ext_a.rng.numpy()[me]
                  - ext_b.rng.numpy()[me]).max() < FUSED_RNG_ATOL


def test_make_image_bit_equal_to_jax_script(scan):
    cfg, sem = JSlamConfig(), jslim()

    @jax.jit
    def make_image(pts, lbl, val):
        # scripts/train_rangenet_synthetic.py:46-57
        pre = jpre.pretreat(pts, val, cfg.sensor)
        img = jproj.project(
            pre.points[:, :3], pre.points[:, 3], pre.ring,
            jnp.asarray(lbl, jnp.float32), pre.valid, cfg.sensor)
        x = jrn.build_input_image(
            img.rng, img.xyz, img.intensity, img.mask, sem)
        lab = jnp.round(img.time).astype(jnp.int8)
        return x, jnp.where(img.mask, lab, 0), img.mask

    pts, lab, valid = scan
    want = make_image(jnp.asarray(pts), jnp.asarray(lab), jnp.asarray(valid))
    got = recipe.make_image(_t(pts), _t(lab), _t(valid), SlamConfig().sensor,
                            slim_semantic_config())
    for g, w, name in zip(got, want, ("image", "labels", "mask")):
        assert g.numpy().dtype == np.asarray(w).dtype, name
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=name)
    assert got[1].numpy().max() > 0
