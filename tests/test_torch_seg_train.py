"""Port parity of RangeNet training (lis_slam_torch/train/seg_train.py and
the train mode of models/rangenet.py) against
lis_slam_tpu/train/seg_train.py, at the slim widths of
tests/test_torch_rangenet.py (config.slim_semantic_config) on a 64 x 128
image, batch 2.

- One float32 step from the same weights and batch: loss within 1e-5 and
  grad_norm within 1e-4 (relative); the batch statistics after the step
  within 1e-4 relative to each array's largest entry; the gradients
  within 5e-3 (global, relative); the port's parameters after the step
  equal to optax.adam's step on the port's gradients (1e-4 x lr), and to
  JAX's parameters within 2e-3 x lr wherever the gradient is above 5% of
  its array's largest (>= 75% of the entries). Adam's first step is
  lr g / (|g| + eps), about lr sign(g), so it turns on the gradient's
  rounding near 0. A float64 evaluation of the port's function put the
  port's float32 gradient within 1e-6 of it (global) and the jitted JAX
  one within 1.8e-3, up to 4.5% of a leaf's largest entry in the deepest
  decoder block; that is where the gates come from.
- Train-mode BatchNorm against numpy: normalized by the batch mean and
  the biased batch variance, running statistics moved 0.01 toward them.
- Five bf16 steps on a fixed batch: the loss falls (the JAX test's
  assertion, tests/test_rangenet_train.py:66-80).
- The weights carried both ways: a JAX TrainState (with its Adam moments)
  into the port and the port's trained model back to a flax tree that
  the JAX module and SemanticSlam load.
"""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")

import jax
import jax.numpy as jnp
import optax
import torch

from lis_slam_tpu.config import slim_semantic_config as jslim
from lis_slam_tpu.models import rangenet as jrn
from lis_slam_tpu.train import seg_train as jtrain
from lis_slam_torch.config import SemanticConfig
from lis_slam_torch.models import rangenet as rn
from lis_slam_torch.semantic import weights as W
from lis_slam_torch.train import seg_train

LR = 3e-3
SHAPE = (2, 64, 128)


def _cfgs(fp16: bool):
    j = dataclasses.replace(jslim(), fp16=fp16, model_input_w=128)
    return j, SemanticConfig(**dataclasses.asdict(j))


def _batch(seed=0):
    r = np.random.default_rng(seed)
    images = r.normal(size=SHAPE + (5,)).astype(np.float32)
    labels = r.integers(0, 20, SHAPE).astype(np.int32)
    mask = r.random(SHAPE) > 0.2
    return images, labels, mask


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, key) if isinstance(v, dict) else {key: v})
    return out


@pytest.fixture(scope="module")
def f32_step():
    jcfg, tcfg = _cfgs(fp16=False)
    model, tx, state = jtrain.create_train_state(jax.random.PRNGKey(0), jcfg,
                                                 lr=LR, input_w=128)
    images, labels, mask = _batch()
    step = jax.jit(jtrain.make_train_step(model, tx))
    new, metrics = step(state, jnp.asarray(images), jnp.asarray(labels),
                        jnp.asarray(mask))
    start = {"params": _np_tree(state.params),
             "batch_stats": _np_tree(state.batch_stats)}
    tmodel, opt = seg_train.create_train_state(tcfg, None, lr=LR,
                                               device="cpu", variables=start)
    tm = seg_train.make_train_step(tmodel, opt)(
        torch.from_numpy(images), torch.from_numpy(labels),
        torch.from_numpy(mask))
    return dict(jcfg=jcfg, tcfg=tcfg, start=start, jstate=new,
                jmetrics=metrics, tmodel=tmodel, opt=opt, tmetrics=tm)


def test_f32_step_metrics_match_jax(f32_step):
    jm, tm = f32_step["jmetrics"], f32_step["tmetrics"]
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-4)
    assert float(tm["loss"]) > 1.0


def _port_grads(f32_step):
    """The port's gradients of the step, as a flax-layout tree."""
    model = f32_step["tmodel"]
    state = dict(model.state_dict())
    state.update({n: p.grad for n, p in model.named_parameters()})
    return W.from_torch_state(state, f32_step["tcfg"])["params"]


def test_f32_step_state_matches_jax(f32_step):
    got = seg_train.to_variables(f32_step["tmodel"], f32_step["tcfg"])
    jstate = f32_step["jstate"]
    want_bs = _flat(_np_tree(jstate.batch_stats))
    got_bs = _flat(got["batch_stats"])
    assert got_bs.keys() == want_bs.keys()
    for k, w in want_bs.items():
        assert np.abs(got_bs[k] - w).max() <= 1e-4 * np.abs(w).max(), k
    # the gradients: JAX's first moment after one step is 0.1 g
    start = f32_step["start"]["params"]
    grads = _port_grads(f32_step)
    gt = _flat(grads)
    gj = {k: v / 0.1 for k, v in _flat(_np_tree(jstate.opt_state[0].mu))
          .items()}
    assert gt.keys() == gj.keys()
    a = np.concatenate([gt[k].ravel() for k in gj])
    b = np.concatenate([gj[k].ravel() for k in gj])
    assert np.linalg.norm(a - b) <= 5e-3 * np.linalg.norm(b)
    # the port's Adam step is optax.adam's on the port's gradients
    tx = optax.adam(LR)
    upd, _ = tx.update(grads, tx.init(start), start)
    want_own = _flat(_np_tree(optax.apply_updates(start, upd)))
    got_p = _flat(got["params"])
    for k, w in want_own.items():
        np.testing.assert_allclose(got_p[k], w, atol=1e-4 * LR, err_msg=k)
    # and JAX's params after its step, where the gradient is clear of 0
    want = _flat(_np_tree(jstate.params))
    n_checked = 0
    for k, w in want.items():
        clear = np.abs(gj[k]) > 0.05 * np.abs(gj[k]).max()
        assert np.all(np.abs(got_p[k] - w)[clear] <= 2e-3 * LR), k
        n_checked += clear.sum()
    assert n_checked > 0.75 * sum(v.size for v in want.values())


def test_train_batch_norm_is_flax_rule():
    rng = np.random.default_rng(3)
    x = rng.normal(2.0, 3.0, (2, 6, 4, 10)).astype(np.float32)
    bn = rn._bn2d(6).train()
    with torch.no_grad():
        bn.weight.copy_(torch.linspace(0.5, 1.5, 6))
        bn.bias.copy_(torch.linspace(-1, 1, 6))
    y = rn._batch_norm(bn, torch.from_numpy(x)).detach().numpy()
    mean = x.mean(axis=(0, 2, 3))
    var = x.var(axis=(0, 2, 3))  # biased
    np.testing.assert_allclose(bn.running_mean.numpy(), 0.01 * mean,
                               rtol=1e-5)
    np.testing.assert_allclose(bn.running_var.numpy(), 0.99 + 0.01 * var,
                               rtol=1e-5)
    want = ((x - mean[:, None, None]) / np.sqrt(var + 1e-4)[:, None, None]
            * bn.weight.detach().numpy()[:, None, None]
            + bn.bias.detach().numpy()[:, None, None])
    np.testing.assert_allclose(y, want, atol=1e-4)
    # eval mode reads the running statistics and leaves them
    bn.eval()
    before = bn.running_var.clone()
    rn._batch_norm(bn, torch.from_numpy(x))
    assert torch.equal(bn.running_var, before)


@pytest.fixture
def one_thread():
    """bf16 training on the CPU in one thread: as fast alone (~1.5 s for
    the five steps), and with the other test workers on the cores its
    multithreaded form took 340 s."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_bf16_steps_reduce_loss(one_thread):
    _, tcfg = _cfgs(fp16=True)
    gen = torch.Generator().manual_seed(0)
    model, opt = seg_train.create_train_state(tcfg, gen, lr=LR,
                                              device="cpu")
    assert model.Darknet53Encoder_0.ConvBnLeaky_0.Conv_0.weight.dtype == \
        torch.float32
    step = seg_train.make_train_step(model, opt)
    images, labels, mask = (torch.from_numpy(a) for a in _batch(1))
    losses = [float(step(images, labels, mask)["loss"]) for _ in range(5)]
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0]


def test_weights_cross_both_ways(f32_step, tmp_path):
    """JAX TrainState -> the port (model and Adam state), and the port's
    trained tree -> the JAX module and the port's eval model."""
    jcfg, tcfg = f32_step["jcfg"], f32_step["tcfg"]
    jstate = f32_step["jstate"]
    model, opt = seg_train.create_train_state(
        tcfg, torch.Generator().manual_seed(1), lr=LR, device="cpu")
    adam = jstate.opt_state[0]
    seg_train.load_jax_train_state(
        model, opt, tcfg, _np_tree(jstate.params),
        _np_tree(jstate.batch_stats), _np_tree(adam.mu), _np_tree(adam.nu),
        int(adam.count))
    back = seg_train.to_variables(model, tcfg)
    for tree, want in ((back["params"], jstate.params),
                       (back["batch_stats"], jstate.batch_stats)):
        w = _flat(_np_tree(want))
        for k, v in _flat(tree).items():
            np.testing.assert_array_equal(v, w[k], err_msg=k)
    name, p = next(iter(model.named_parameters()))
    assert float(opt.state[p]["step"]) == 1.0
    mu = W.to_torch_state({"params": _np_tree(adam.mu),
                           "batch_stats": _np_tree(jstate.batch_stats)},
                          tcfg)[name]
    assert torch.equal(opt.state[p]["exp_avg"], mu)
    # the port's trained tree through the JAX module and the port's eval
    # model: the same logits
    trained = seg_train.to_variables(f32_step["tmodel"], tcfg)
    x = np.random.default_rng(5).normal(size=(1, 64, 128, 5)).astype(
        np.float32)
    jl = np.asarray(jrn.create_model(jcfg).apply(trained, jnp.asarray(x)))
    ev = rn.create_model(tcfg)
    ev.load_state_dict(W.to_torch_state(trained, tcfg))
    with torch.no_grad():
        tl = ev(torch.from_numpy(x)).numpy()
    assert np.abs(tl - jl).max() <= 1e-3 * np.abs(jl).max()
