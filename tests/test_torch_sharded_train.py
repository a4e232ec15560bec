"""The sharded RangeNet training step (lis_slam_torch/train/seg_train.py
make_sharded_train_step, models/rangenet.py forward_sharded) on gloo ranks
on the CPU, at the slim widths of tests/test_torch_seg_train.py
(config.slim_semantic_config), 64 x 128, batch 2.

- JAX's make_sharded_train_step on a (data 2, model 2, space 2) mesh of
  the 8 virtual CPU devices against the port's on 8 ranks of the same
  mesh shape, from the same weights (through the flax-layout tree
  load_jax_train_state takes) and batch, float32: the gates of
  tests/test_torch_seg_train.py (loss 1e-5, grad_norm 1e-4, batch
  statistics 1e-4 of each array's largest, gradients 5e-3 global,
  parameters after the step within 2e-3 x lr where the gradient is above
  5% of its leaf's largest).
- The port's sharded step on (data 2, model 2) and (model 2, space 2)
  against its unsharded one. In float64 (a float64 model; the unsharded
  module computes BatchNorm in float32 always, so the float64 reference is
  the same sharded code on a world of one process): loss, grad_norm and
  every gradient leaf within 1e-6 relative (max |difference| over the
  leaf's largest entry). In float32 against seg_train.make_train_step:
  loss within 1e-6 relative, grad_norm within 1e-4 and the gradients
  within 5e-3 (global), the seg_train gates. Per leaf, on (model 2, space 2), the
  float32 gradient of the decoder's second transposed conv differs by ~3%
  of the leaf's largest entry: flax's variance E[x^2] - E[x]^2, which
  both steps take, cancels there, and the width blocks sum in another
  order; the float64 comparison shows the sharding itself exact to
  ~1e-14.
- Train-mode BatchNorm over (data 2, space 2) blocks against numpy over
  the global batch; the halo convolutions (3 x 3, stride (1, 2),
  the (1, 4) transposed conv) over 4 'space' ranks against the unsharded
  convolution, forward and backward, float64 (1e-12).
- A JAX TrainState loaded through load_jax_train_state, sharded and
  gathered back bit for bit.
- dryrun_multichip(4) at slim widths.

The rank processes import tests/_torch_mesh_ranks.py, never JAX.
"""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")

import jax
import jax.numpy as jnp
import torch

import _torch_mesh_ranks as ranks
from lis_slam_tpu.config import slim_semantic_config as jslim
from lis_slam_tpu.parallel import mesh as jmesh
from lis_slam_tpu.train import seg_train as jtrain
from lis_slam_torch import entry
from lis_slam_torch.config import SemanticConfig
from lis_slam_torch.models import rangenet as rn
from lis_slam_torch.parallel import mesh as pmesh
from lis_slam_torch.semantic import weights as W
from lis_slam_torch.train import seg_train

LR = 3e-3
SHAPE = (2, 64, 128)


def _cfgs(fp16=False, w=128):
    j = dataclasses.replace(jslim(), fp16=fp16, model_input_w=w)
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


def _rel(a, b):
    return abs(a - b) / abs(b)


def _spawn_cases():
    r = np.random.default_rng(2)

    def f64(*shape):
        return torch.from_numpy(r.normal(size=shape))

    conv_cases = {
        "same": (f64(2, 3, 4, 64), f64(5, 3, 3, 3), f64(2, 5, 4, 64)),
        "down": (f64(2, 3, 4, 64), f64(5, 3, 3, 3), f64(2, 5, 4, 32)),
        "deconv": (f64(2, 3, 4, 64), f64(3, 5, 1, 4), f64(2, 5, 4, 128))}
    x = r.normal(2.0, 3.0, (4, 6, 3, 16)).astype(np.float32)
    bn_case = (torch.from_numpy(x), torch.linspace(0.5, 1.5, 6),
               torch.linspace(-1, 1, 6))
    return conv_cases, bn_case


@pytest.fixture(scope="module")
def runs():
    """From PRNGKey(0)'s weights and one batch: the port's 8 ranks on
    (data 2, model 2, space 2) and one 4-rank spawn (the float32 and
    float64 steps on (data 2, model 2) and (model 2, space 2), the halo
    convolutions, BatchNorm), both started in threads while JAX compiles
    its unsharded step and its sharded step on (data 2, model 2), and the
    float64 step on the world of one is computed here."""
    from concurrent.futures import ThreadPoolExecutor

    jcfg, tcfg = _cfgs()
    model, tx, state = jtrain.create_train_state(jax.random.PRNGKey(0), jcfg,
                                                 lr=LR, input_w=128)
    start = {"params": _np_tree(state.params),
             "batch_stats": _np_tree(state.batch_stats)}
    batch = _batch()
    conv_cases, bn_case = _spawn_cases()
    with ThreadPoolExecutor(2) as pool:
        p222 = pool.submit(pmesh.spawn, 8, seg_train.train_sharded, tcfg,
                           start, *batch, LR, 1, 2, 2, device="cpu")
        p4 = pool.submit(pmesh.spawn, 4, ranks.sharded_train_checks, tcfg,
                         start, *batch, conv_cases, bn_case, device="cpu")
        images, labels, mask = (jnp.asarray(a) for a in batch)
        jax_none = jax.device_get(jax.jit(jtrain.make_train_step(model, tx))(
            state, images, labels, mask))
        mesh = jmesh.make_mesh(4, model_parallel=2)
        step, shard_state, batch_sh = jtrain.make_sharded_train_step(
            model, tx, mesh)
        jax_22 = jax.device_get(step(
            shard_state(state), *(jax.device_put(a, batch_sh)
                                  for a in (images, labels, mask))))
        ref64 = ranks.step64(None, tcfg, start, *batch)
        return dict(tcfg=tcfg, start=start, batch=batch,
                    conv_cases=conv_cases, bn_case=bn_case, jax=jax_none,
                    jax_22=jax_22, ref64=ref64, port_222=p222.result(),
                    res=p4.result())


def _hold_to_jax(port, jstate, jm, start, tcfg):
    """tests/test_torch_seg_train.py's gates."""
    assert _rel(port["losses"][0], float(jm["loss"])) <= 1e-5
    assert _rel(port["grad_norms"][0], float(jm["grad_norm"])) <= 1e-4
    got = port["variables"]
    want_bs = _flat(_np_tree(jstate.batch_stats))
    got_bs = _flat(got["batch_stats"])
    assert got_bs.keys() == want_bs.keys()
    for k, w in want_bs.items():
        assert np.abs(got_bs[k] - w).max() <= 1e-4 * np.abs(w).max(), k
    grads = _flat(W.from_torch_state(
        {**W.to_torch_state(start, tcfg), **port["grads"]}, tcfg)["params"])
    gj = {k: v / 0.1 for k, v in _flat(_np_tree(jstate.opt_state[0].mu))
          .items()}
    assert grads.keys() == gj.keys()
    a = np.concatenate([grads[k].ravel() for k in gj])
    b = np.concatenate([gj[k].ravel() for k in gj])
    assert np.linalg.norm(a - b) <= 5e-3 * np.linalg.norm(b)
    want = _flat(_np_tree(jstate.params))
    got_p = _flat(got["params"])
    n_checked = 0
    for k, w in want.items():
        clear = np.abs(gj[k]) > 0.05 * np.abs(gj[k]).max()
        assert np.all(np.abs(got_p[k] - w)[clear] <= 2e-3 * LR), k
        n_checked += clear.sum()
    assert n_checked > 0.75 * sum(v.size for v in want.values())


def test_sharded_step_222_matches_jax(runs):
    """The port on (data 2, model 2, space 2) against JAX's step. JAX's
    own sharded step on that mesh of virtual CPU devices is off its
    unsharded step (grad_norm 0.7714 against 0.8256, the stem kernel's
    gradient by 62% of its largest entry; every two-axis mesh agrees,
    scripts/jax_sharded_step_check.py), so the port is held to JAX's
    unsharded step, which a correct sharded step equals."""
    _hold_to_jax(runs["port_222"], *runs["jax"], runs["start"], runs["tcfg"])


def test_sharded_step_22_matches_jax_sharded(runs):
    """The port and JAX, both sharded on (data 2, model 2)."""
    _hold_to_jax(runs["res"][("f32", 2, 1)], *runs["jax_22"], runs["start"],
                 runs["tcfg"])


@pytest.mark.parametrize("mp,sp", [(2, 1), (2, 2)])
def test_sharded_step_matches_unsharded_f64(runs, mp, sp):
    loss, norm, grads = runs["res"][("f64", mp, sp)]
    l1, n1, g1 = runs["ref64"]
    assert _rel(loss, l1) <= 1e-6 and _rel(norm, n1) <= 1e-6
    assert grads.keys() == g1.keys()
    for k, g in g1.items():
        assert float((grads[k] - g).abs().max()) <= 1e-6 * float(
            g.abs().max()), k


@pytest.mark.parametrize("mp,sp", [(2, 1), (2, 2)])
def test_sharded_step_matches_unsharded_f32(runs, mp, sp):
    out = runs["res"][("f32", mp, sp)]
    model, opt = seg_train.create_train_state(
        runs["tcfg"], None, lr=LR, device="cpu",
        variables=runs["start"])
    ref = seg_train.make_train_step(model, opt)(
        *(torch.from_numpy(a) for a in runs["batch"]))
    assert _rel(out["losses"][0], float(ref["loss"])) <= 1e-6
    assert _rel(out["grad_norms"][0], float(ref["grad_norm"])) <= 1e-4
    names = [n for n, _ in model.named_parameters()]
    a = torch.cat([out["grads"][n].reshape(-1) for n in names])
    b = torch.cat([p.grad.reshape(-1) for p in model.parameters()])
    assert float((a - b).norm()) <= 5e-3 * float(b.norm())
    # the trained tree crosses back to the flax layout whole
    tree = out["variables"]
    assert _flat(tree["params"]).keys() == _flat(
        runs["start"]["params"]).keys()


def test_train_batch_norm_global_statistics(runs):
    """Normalized by the global batch mean and biased variance over
    (data, space) blocks, the running statistics moved 0.01 toward them,
    the same on every rank (rank 0 returned)."""
    x, weight, bias = (t.numpy() for t in runs["bn_case"])
    y, run_mean, run_var = runs["res"]["bn"]
    mean = x.mean(axis=(0, 2, 3))
    var = x.var(axis=(0, 2, 3))
    np.testing.assert_allclose(run_mean.numpy(), 0.01 * mean, rtol=1e-5)
    np.testing.assert_allclose(run_var.numpy(), 0.99 + 0.01 * var, rtol=1e-5)
    want = ((x - mean[:, None, None]) / np.sqrt(var + 1e-4)[:, None, None]
            * weight[:, None, None] + bias[:, None, None])
    np.testing.assert_allclose(y.detach().numpy(), want, atol=1e-4)


@pytest.mark.parametrize("kind", ["same", "down", "deconv"])
def test_halo_convolutions(runs, kind):
    y, gx, gw = runs["res"]["conv"][kind]
    ry, rgx, rgw = ranks.conv_reference(kind, *runs["conv_cases"][kind])
    assert y.shape == ry.shape
    for got, want in ((y, ry), (gx, rgx), (gw, rgw)):
        assert float((got - want).abs().max()) <= 1e-12 * float(
            want.abs().max())


def test_state_sharding_round_trip(runs):
    """A JAX TrainState loaded into the port, cut into (model 2, space 2)
    shards and gathered back, on every rank: weights and Adam moments bit
    for bit, and each shard smaller than the whole."""
    assert runs["res"]["round_trip"] == [(True, True)] * 4


def test_eval_forward_world_of_one_equals_module(runs):
    """forward_sharded on the world of one (no process group) is the
    module's forward, bit for bit, in eval mode."""
    tcfg = runs["tcfg"]
    model = rn.create_model(tcfg, param_dtype=torch.float32)
    model.load_state_dict(W.to_torch_state(runs["start"], tcfg))
    x = torch.from_numpy(runs["batch"][0])
    with torch.no_grad():
        assert torch.equal(rn.forward_sharded(model, x, None, ()), model(x))
    with pytest.raises(ValueError, match="multiple of 32"):
        rn.forward_sharded(model, x[:, :, :48], None, ())


def test_dryrun_multichip_4():
    _, slim = _cfgs(fp16=True, w=64)
    out = entry.dryrun_multichip(4, device="cpu", semantic=slim)
    assert out["mesh"] == {"data": 1, "model": 2, "space": 2}
    assert np.isfinite(out["loss"])
    assert out["poses"].shape == (4, 6) and np.all(np.isfinite(out["poses"]))
