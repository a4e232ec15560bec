"""Port parity of the synthetic RangeNet training recipe
(lis_slam_torch/train/seg_train.py warmup_cosine_decay,
clip_by_global_norm_, make_train_step's schedule and clip;
lis_slam_torch/train/recipe.py; scripts/train_rangenet_synthetic_torch.py)
against optax and the JAX package's scripts/train_rangenet_synthetic.py.
CPU, float32, one thread.

- The schedule against optax.warmup_cosine_decay_schedule at every step
  from 0 to steps + 2, rtol 1e-6 (optax evaluates it in float32).
- The clip against optax.clip_by_global_norm(1.0) on trees below (left
  bit-equal) and above the norm (rtol 1e-6), and not torch's
  clip_grad_norm_ rule (norm + 1e-6).
- Three steps of the recipe's optimizer (optax.chain(clip_by_global_norm,
  adam(warmup_cosine_decay_schedule(0, lr, 1, 3, lr * 0.02)))) against
  JAX's make_train_step from the same variables and batches, at a narrow
  float32 RangeNet on 8 x 64 images: step 0 (lr 0) moves no parameter.
  The clip is at CLIP = 2.0, not the recipe's 1.0: at this width the
  random-label batches' gradient norms sit at ~1.4 and a one-class
  batch's at ~2.5, so step 1 (one class) is clipped and steps 0 and 2
  (random labels) pass. Loss rtol 1e-5 and grad_norm rtol 1e-4
  per step (tests/test_torch_seg_train.py's gates); every parameter after
  the three steps within 2e-3 x lr of JAX's (measured: 4.7e-4 x lr; Adam
  steps by about lr sign(g), so a gradient's rounding near 0 shows at
  that scale).
- The CLI, scripts/train_rangenet_synthetic_torch.py --cpu, trains two
  steps on a tiny cached dataset and writes a checkpoint that the JAX
  package's semantic.weights.load_checkpoint reads back: the same arrays
  (float16 parameters, float32 statistics) and the meta keys.
"""

import dataclasses
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")

import jax
import jax.numpy as jnp
import optax
import torch

from lis_slam_tpu.config import slim_semantic_config as jslim
from lis_slam_tpu.models import rangenet as jrn
from lis_slam_tpu.semantic import weights as JW
from lis_slam_tpu.train import seg_train as jtrain
from lis_slam_torch.config import SemanticConfig
from lis_slam_torch.semantic import weights as W
from lis_slam_torch.train import recipe, seg_train

_REPO = Path(__file__).resolve().parents[1]
LR = 2e-3
SHAPE = (2, 8, 64)  # batch, rows, columns
CLIP = 2.0
PARAM_ATOL_LR = 2e-3  # x lr, the parameters after three steps
ONE_CLASS = (False, True, False)  # step 1's labels all one class: clipped


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("steps,lr", [(2500, 2e-3), (7, 1e-2), (3, 0.5)])
def test_schedule_matches_optax(steps, lr):
    warmup = min(100, max(steps // 5, 1))
    want = optax.warmup_cosine_decay_schedule(0.0, lr, warmup, steps,
                                              lr * 0.02)
    got = seg_train.recipe_schedule(steps, lr)
    ks = np.arange(steps + 3)
    w = np.asarray(jax.vmap(want)(jnp.asarray(ks)), np.float64)
    g = np.array([got(int(k)) for k in ks])
    assert g[0] == 0.0
    np.testing.assert_allclose(g, w, rtol=1e-6)
    assert g[-1] == pytest.approx(lr * 0.02)


def _tree(seed, scale):
    r = np.random.default_rng(seed)
    return {"a": (scale * r.normal(size=(3, 4))).astype(np.float32),
            "b": {"c": (scale * r.normal(size=(7,))).astype(np.float32)}}


@pytest.mark.parametrize("scale", [0.05, 3.0])
def test_clip_matches_optax(scale):
    tree = _tree(1, scale)
    tx = optax.clip_by_global_norm(1.0)
    want, _ = tx.update(tree, tx.init(tree))
    leaves = [torch.from_numpy(tree["a"].copy()),
              torch.from_numpy(tree["b"]["c"].copy())]
    norm = torch.linalg.vector_norm(torch.stack(
        torch._foreach_norm(leaves)))
    seg_train.clip_by_global_norm_(leaves, 1.0, norm)
    want = [np.asarray(want["a"]), np.asarray(want["b"]["c"])]
    if float(norm) < 1.0:
        for g, w, orig in zip(leaves, want, (tree["a"], tree["b"]["c"])):
            np.testing.assert_array_equal(g.numpy(), w)
            np.testing.assert_array_equal(g.numpy(), orig)
    else:
        for g, w in zip(leaves, want):
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-6, atol=0)
        # torch's clip_grad_norm_ divides by norm + 1e-6: another rule
        t = [torch.from_numpy(tree["a"].copy()).requires_grad_()]
        t[0].grad = t[0].detach().clone()
        torch.nn.utils.clip_grad_norm_(t, 1.0)
        assert not np.array_equal(t[0].grad.numpy(), leaves[0].numpy())


def _narrow():
    j = dataclasses.replace(jslim(), fp16=False, model_input_h=SHAPE[1],
                            model_input_w=SHAPE[2], enc_blocks=(1,) * 5,
                            enc_widths=(8, 8, 16, 16, 16),
                            dec_widths=(16, 16, 8, 8, 8))
    return j, SemanticConfig(**dataclasses.asdict(j))


def _batches():
    out = []
    for i, one in enumerate(ONE_CLASS):
        r = np.random.default_rng(10 + i)
        labels = r.integers(0, 20, SHAPE).astype(np.int32)
        if one:
            labels[:] = 3
        out.append((r.normal(size=SHAPE + (5,)).astype(np.float32), labels,
                    r.random(SHAPE) > 0.2))
    return out


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, key) if isinstance(v, dict) else {key: v})
    return out


def test_three_recipe_steps_match_jax(one_thread):
    jcfg, tcfg = _narrow()
    model, variables = jrn.init_params(jax.random.PRNGKey(3), jcfg,
                                       input_w=SHAPE[2])
    sched = optax.warmup_cosine_decay_schedule(0.0, LR, 1, 3, LR * 0.02)
    tx = optax.chain(optax.clip_by_global_norm(CLIP), optax.adam(sched))
    state = jtrain.TrainState(params=variables["params"],
                              batch_stats=variables["batch_stats"],
                              opt_state=tx.init(variables["params"]),
                              step=jnp.int32(0))
    jstep = jax.jit(jtrain.make_train_step(model, tx))
    start = {"params": _np_tree(variables["params"]),
             "batch_stats": _np_tree(variables["batch_stats"])}
    tmodel, opt = seg_train.create_train_state(tcfg, None, lr=LR,
                                               device="cpu", variables=start)
    tstep = seg_train.make_train_step(
        tmodel, opt, seg_train.warmup_cosine_decay(0.0, LR, 1, 3, LR * 0.02),
        max_grad_norm=CLIP)
    norms = []
    for k, (x, y, m) in enumerate(_batches()):
        state, jm = jstep(state, jnp.asarray(x), jnp.asarray(y),
                          jnp.asarray(m))
        tm = tstep(*(torch.from_numpy(a) for a in (x, y, m)))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5, err_msg=f"step {k}")
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4,
                                   err_msg=f"step {k}")
        norms.append(float(tm["grad_norm"]))
        if k == 0:  # lr(0) = 0: Adam's moments move, the parameters not
            got = _flat(seg_train.to_variables(tmodel, tcfg)["params"])
            for key, v in _flat(start["params"]).items():
                np.testing.assert_array_equal(got[key], v, err_msg=key)
    assert norms[1] > CLIP > max(norms[0], norms[2]), norms
    # the parameters after the clipped step and the last
    got = _flat(seg_train.to_variables(tmodel, tcfg)["params"])
    want = _flat(_np_tree(state.params))
    assert got.keys() == want.keys()
    for key, w in want.items():
        np.testing.assert_allclose(got[key], w, rtol=0, atol=PARAM_ATOL_LR
                                   * LR, err_msg=key)
    moved = np.concatenate([np.abs(got[k] - v).ravel() for k, v
                            in _flat(start["params"]).items()])
    assert moved.max() > 0.5 * LR


def _load_cli():
    path = _REPO / "scripts" / "train_rangenet_synthetic_torch.py"
    spec = importlib.util.spec_from_file_location("train_synth_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_cli_checkpoint_loads_in_jax(tmp_path, one_thread):
    """Two CPU steps of the CLI on 12 images (two rendered scans, each six
    times: the recipe holds out the last 10) from its --cache file."""
    data = recipe.render_dataset(n_worlds=1, scans_per_world=2,
                                 device="cpu")
    assert data.images.shape == (2, 64, recipe.H_PAD, 5)
    assert data.images.dtype == torch.float16
    assert data.labels.dtype == torch.int8 and data.masks.dtype == torch.bool
    assert not data.masks[:, 1::2].any()  # the odd rings are not kept
    cache, out = tmp_path / "data.npz", tmp_path / "ckpt" / "slim.npz"
    np.savez(cache, **{k: t.repeat(6, 1, 1, *([1] * (t.dim() - 3))).numpy()
                       for k, t in zip(("imgs", "labs", "masks"), data)})
    assert _load_cli().main(["--steps", "2", "--batch", "2", "--cpu",
                             "--cache", str(cache), "--out", str(out)]) == 0
    meta = json.loads(str(np.load(out)["__meta__"]))
    assert {"miou_synthetic", "steps"} <= meta.keys()
    assert meta["steps"] == 2 and 0.0 <= meta["miou_synthetic"] <= 1.0
    jcfg, jvars = JW.load_checkpoint(str(out))
    tcfg, tvars = W.load_checkpoint(str(out))
    assert jcfg.enc_widths == tcfg.enc_widths == jslim().enc_widths
    want, got = _flat(_np_tree(jvars)), _flat(tvars)
    assert want.keys() == got.keys()
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    # the trained weights run through the JAX module
    x = np.asarray(data.images[:1, :, :512], np.float32)
    logits = jrn.create_model(jcfg).apply(jvars, jnp.asarray(x))
    assert logits.shape == (1, 64, 512, 20)
    assert np.isfinite(np.asarray(logits)).all()
