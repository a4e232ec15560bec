"""The port's bf16 convolutions on the CPU (lis_slam_torch/models/
rangenet.py `_conv`) against JAX's CPU convolutions in bf16, on the same
seeded numpy inputs.

torch's own CPU bf16 F.conv2d reads memory nothing wrote where a
stride-(1, 2) conv leaves one output column (a 3- or 4-column input): on
an all-zero input it returned nonzero values in most calls, and the
4-rank sharded dryrun, whose last encoder conv sees 1 local column plus 2
halo columns, gave a NaN loss. JAX's CPU answer is the float32
convolution rounded once to bf16, which `_conv` computes.

- The encoder's strided conv (3 x 3, stride (1, 2), 48 -> 64 channels, no
  width pads, as _conv_sharded calls it) at widths 3, 4, 8 and 64: exact
  zeros on a zero input; on random inputs the output and both gradients
  within one bf16 ulp of JAX's, the ulp taken at the sum of the
  magnitudes of each value's terms (the bound any float32 summation
  order keeps once rounded to bf16). At widths 3 and 4 (one output
  column) every output value is also within one ulp of JAX's own and at
  least 0.999 of them equal it bit for bit: the float32 sums run in
  another order than XLA's, and on seed 0 one value of 4096 at width 3
  rounds to the next bf16. Before the repair these two cases failed
  (bit-equal share ~0.03, NaN among the values); 8 and 64 passed.
- The decoder's transposed conv (kernel (1, 4), stride (1, 2)) at its
  narrowest widths: 1 local column with its two halo columns (the
  sharded forward's padding 3) and the 2 columns of a 64-wide image.
- float32 and float64: `_conv` is F.conv2d / F.conv_transpose2d, bit for
  bit, forward and backward.
- entry.dryrun_multichip's rank on 4 gloo ranks with jaxlib loaded in
  each: the sharded bf16 step's loss equal to the unsharded step's (NaN
  before the repair, in every run); the dryrun's errors name the rank
  and its mesh coordinates.
"""

import dataclasses
import types

import numpy as np
import pytest

pytest.importorskip("jax")

import jax
import jax.numpy as jnp
import torch
import torch.nn.functional as F
from jax import lax

import _torch_mesh_ranks as ranks
from lis_slam_torch import entry
from lis_slam_torch.config import SemanticConfig, slim_semantic_config
from lis_slam_torch.models import rangenet as rn
from lis_slam_torch.parallel import mesh as pmesh
from lis_slam_torch.train import seg_train

_DN = ("NCHW", "OIHW", "NCHW")


def _key(t: torch.Tensor) -> np.ndarray:
    """bf16 values as integers in their order (one apart: one ulp)."""
    i = t.contiguous().view(torch.int16).numpy().astype(np.int32)
    return np.where(i < 0, -(i & 0x7FFF), i)


def _ulp(s: np.ndarray) -> np.ndarray:
    """The bf16 ulp at magnitude s >= 0 (0 where s is 0)."""
    _, e = np.frexp(s)
    return np.where(s > 0, np.ldexp(1.0, e - 8), 0.0)


def _bf16(a) -> torch.Tensor:
    return torch.from_numpy(np.array(jnp.asarray(a, jnp.float32))).bfloat16()


def _jax_conv(transposed, pad):
    """JAX's bf16 convolution with the torch layout and padding: x NCHW,
    w OIHW (IOHW, transposed); a transposed conv as the input-dilated
    conv of the flipped kernel, flax's ConvTranspose."""
    if not transposed:
        return lambda x, w: lax.conv_general_dilated(
            x, w, (1, 2), ((pad[0],) * 2, (pad[1],) * 2),
            dimension_numbers=_DN)
    return lambda x, w: lax.conv_general_dilated(
        x, jnp.flip(w, -1).transpose(1, 0, 2, 3), (1, 1),
        ((0, 0), (3 - pad[1],) * 2), lhs_dilation=(1, 2),
        dimension_numbers=_DN)


def _case(x_shape, w_shape, transposed, pad, seed):
    """The port's output and input / weight gradients, JAX's, and the
    float64 sums of their terms' magnitudes."""
    r = np.random.default_rng(seed)
    x = r.normal(size=x_shape).astype(np.float32)
    w = (r.normal(size=w_shape) / np.sqrt(np.prod(w_shape[1:]))).astype(
        np.float32)
    y, vjp = jax.vjp(_jax_conv(transposed, pad), jnp.asarray(x, jnp.bfloat16),
                     jnp.asarray(w, jnp.bfloat16))
    g = r.normal(size=y.shape).astype(np.float32)
    jax_out = (_bf16(y), *(_bf16(a) for a in vjp(jnp.asarray(g,
                                                             jnp.bfloat16))))

    xt = torch.from_numpy(x).bfloat16().requires_grad_(True)
    wt = torch.from_numpy(w).bfloat16().requires_grad_(True)
    yt = rn._conv(xt, wt, None, (1, 2), pad, transposed)
    yt.backward(torch.from_numpy(g).bfloat16())
    port = (yt.detach(), xt.grad, wt.grad)

    conv = F.conv_transpose2d if transposed else F.conv2d
    xa = xt.detach().double().abs().requires_grad_(True)
    wa = wt.detach().double().abs().requires_grad_(True)
    ya = conv(xa, wa, None, (1, 2), pad)
    (ya * torch.from_numpy(g).bfloat16().double().abs()).sum().backward()
    sums = (ya.detach(), xa.grad, wa.grad)
    zero = rn._conv(torch.zeros(x_shape, dtype=torch.bfloat16), wt.detach(),
                    None, (1, 2), pad, transposed)
    return port, jax_out, sums, zero


def _hold(port, jax_out, sums):
    for name, p, j, s in zip(("y", "grad x", "grad w"), port, jax_out, sums):
        assert p.dtype == torch.bfloat16 and p.shape == j.shape, name
        err = (p.double() - j.double()).abs().numpy()
        bad = err > _ulp(s.numpy())
        assert not bad.any(), (name, int(bad.sum()), float(err.max()))


@pytest.mark.parametrize("width", [3, 4, 8, 64])
def test_strided_conv_matches_jax(width):
    port, jax_out, sums, zero = _case((1, 48, 66, width), (64, 48, 3, 3),
                                      False, (0, 0), seed=0)
    assert port[0].shape[3] == (width - 3) // 2 + 1
    assert torch.count_nonzero(zero) == 0
    _hold(port, jax_out, sums)
    if width <= 4:  # one output column
        dist = np.abs(_key(port[0]) - _key(jax_out[0]))
        assert dist.max() <= 1 and (dist == 0).mean() >= 0.999


@pytest.mark.parametrize("width,pad", [(3, 3), (2, 1)],
                         ids=["sharded-1col", "unsharded-2col"])
def test_transposed_conv_matches_jax(width, pad):
    """128 -> 48 channels (the slim decoder's first, its 'model' half)."""
    port, jax_out, sums, zero = _case((1, 128, 64, width), (128, 48, 1, 4),
                                      True, (0, pad), seed=1)
    assert port[0].shape[3] == 2 * width + 2 - 2 * pad
    assert torch.count_nonzero(zero) == 0
    _hold(port, jax_out, sums)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("transposed", [False, True])
def test_wide_dtypes_are_the_plain_call(dtype, transposed):
    r = np.random.default_rng(2)
    x = torch.from_numpy(r.normal(size=(2, 8, 6, 5))).to(dtype)
    w = torch.from_numpy(r.normal(size=(8, 4, 3, 3) if transposed
                                  else (4, 8, 3, 3))).to(dtype)
    conv = F.conv_transpose2d if transposed else F.conv2d
    outs = []
    for fn in (lambda a, b: rn._conv(a, b, None, (1, 2), (1, 0), transposed),
               lambda a, b: conv(a, b, None, (1, 2), (1, 0))):
        a, b = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
        y = fn(a, b)
        y.square().sum().backward()
        outs.append((y.detach(), a.grad, b.grad))
    for got, want in zip(*outs):
        assert got.dtype == dtype and torch.equal(got, want)


def test_dryrun_sharded_loss_with_jaxlib_loaded():
    """The dryrun's bf16 step on (data 1, model 2, space 2), all-zero
    images, slim widths at 64 x 64: the loss equals the unsharded step's
    bit for bit (ln 20: every activation is 0)."""
    slim = SemanticConfig(**dataclasses.asdict(dataclasses.replace(
        slim_semantic_config(), fp16=True, model_input_w=64)))
    out = pmesh.spawn(4, ranks.dryrun_with_jaxlib, slim, device="cpu")
    assert out["mesh"] == {"data": 1, "model": 2, "space": 2}
    model, opt = seg_train.create_train_state(
        slim, torch.Generator().manual_seed(0), device="cpu")
    ref = seg_train.make_train_step(model, opt)(
        torch.zeros(1, 64, 64, 5), torch.zeros(1, 64, 64, dtype=torch.int32),
        torch.ones(1, 64, 64, dtype=torch.bool))
    assert out["loss"] == float(ref["loss"])


def test_dryrun_error_names_the_rank():
    """The dryrun's errors say which rank failed and where it sits."""
    mesh = types.SimpleNamespace(mesh_dim_names=("data", "model", "space"),
                                 get_coordinate=lambda: [0, 1, 0])
    assert entry._where(2, mesh) == "rank 2 at (data 0, model 1, space 0)"
