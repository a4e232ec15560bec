"""The port's RangeNet at darknet53's published widths (the default
SemanticConfig, 46.5 M parameters) against the plain float32 reference
`lis_slam_torch/golden/rangenet_plain.py`, on seeded weights (flax's
initializers, `rangenet.init_params`, with BatchNorm statistics redrawn
so that no layer is the identity) and a seeded 8 x 64 normalized image,
a fifth of its pixels empty.

- float32: max |port - reference| <= 1e-4 x max |reference|. The two
  run the same convolutions in float32 on the CPU and differ in the
  order of BatchNorm's arithmetic and in the transposed conv (the port
  flips the kernel once at load, the reference at every call): rounding
  alone, ~6e-7 at this size, compounded over 52 layers.
- bf16 (the convolutions' operands in bf16, as the program runs them):
  the bars of tests/test_torch_rangenet.py, whose slim-checkpoint test
  holds the port to JAX: the argmax equal to JAX's own bf16 forward of
  the same tree on >= 99% of the masked pixels (near-ties flip under bf16
  rounding in either framework), and the port no further from the
  float32 reference than 2 x JAX's bf16 logits are.
"""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")

import jax
import jax.numpy as jnp
import torch

from lis_slam_tpu.config import SemanticConfig as JSemanticConfig
from lis_slam_tpu.models import rangenet as jrn
from lis_slam_torch.config import SemanticConfig
from lis_slam_torch.golden import rangenet_plain
from lis_slam_torch.models import rangenet
from lis_slam_torch.semantic import inference

FP32_RTOL = 1e-4  # rounding order only, over 52 layers (see above)
ARGMAX_AGREE = 0.99  # tests/test_torch_rangenet.py's bf16 bar
H, W = 8, 64


@pytest.fixture(scope="module")
def darknet53():
    """(seeded tree, image (1, H, W, 5), mask (H, W), reference logits)."""
    cfg = SemanticConfig(enabled=True)
    tree = rangenet.init_params(cfg, torch.Generator().manual_seed(53))
    rng = np.random.default_rng(53)

    def redraw(stats):
        for k, v in stats.items():
            if isinstance(v, dict):
                redraw(v)
            elif k == "mean":
                stats[k] = rng.normal(0, 0.2, v.shape).astype(np.float32)
            else:
                stats[k] = rng.uniform(0.5, 2.0, v.shape).astype(np.float32)
    redraw(tree["batch_stats"])
    mask = rng.random((H, W)) > 0.2
    x = np.where(mask[..., None], rng.normal(0, 1, (H, W, 5)), 0.0)
    x = x.astype(np.float32)[None]
    torch.set_num_threads(2)
    ref = rangenet_plain.forward(rangenet_plain.tensors(tree, "cpu"),
                                 torch.from_numpy(x))[0].numpy()
    return tree, x, mask, ref


def _port(tree, x, fp16):
    cfg = SemanticConfig(enabled=True, fp16=fp16)
    model = inference.load_model(tree, cfg, "cpu")
    with torch.no_grad():
        return model(torch.from_numpy(x))[0].numpy()


def test_float32_against_the_plain_reference(darknet53):
    tree, x, _mask, ref = darknet53
    got = _port(tree, x, fp16=False)
    assert got.shape == ref.shape == (H, W, 20)
    scale = np.abs(ref).max()
    assert scale > 0.1
    assert np.abs(got - ref).max() <= FP32_RTOL * scale


def test_bf16_within_the_slim_checkpoints_bars(darknet53):
    tree, x, mask, ref = darknet53
    got = _port(tree, x, fp16=True)
    jcfg = dataclasses.replace(JSemanticConfig(enabled=True), fp16=True)
    jax16 = np.asarray(jax.jit(jrn.create_model(jcfg).apply)(
        tree, jnp.asarray(x)))[0]
    agree = (got.argmax(-1) == jax16.argmax(-1))[mask].mean()
    assert agree >= ARGMAX_AGREE, agree
    jax_gap = np.abs(jax16 - ref)[mask].max()
    assert 0 < np.abs(got - ref)[mask].max() <= 2 * jax_gap
