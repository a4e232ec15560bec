"""Port parity of RangeNet (models/rangenet.py) and its weights
(semantic/weights.py) against lis_slam_tpu/models/rangenet.py and
lis_slam_tpu/semantic/weights.py. One flax-layout tree drives both
packages, carried onto the port by `weights.to_torch_state`.

- The two layers where flax and torch conventions part: a stride-(1, 2)
  "SAME" ConvBnLeaky (flax pads the width by (0, 1)) and an UpBlock (flax's
  ConvTranspose does not flip its kernel), float32 with random asymmetric
  weights: max |diff| <= 1e-5 x max |out|.
- The in-repo slim checkpoint at 64 x 1824 on a rendered scan's image:
  float32 logits within 1e-3 x max |logit|, argmax equal on >= 99.9% of
  the masked pixels; bf16 argmax equal on >= 99%, and the bf16 logits no
  further from the float32 reference than 2 x JAX's own bf16 logits.
- The full-size darknet53 (built on the meta device, not run): parameter
  count with batch statistics, layer sequence and shapes against JAX's
  eval_shape, and its FLOPs at 64 x 2048.
- Checkpoint trees, the ONNX layer-order round trip, and the init scheme.
"""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")

import jax
import jax.numpy as jnp
import torch

from lis_slam_tpu.config import SemanticConfig as JSemanticConfig
from lis_slam_tpu.config import SensorConfig as JSensorConfig
from lis_slam_tpu.io import synthetic as jsyn
from lis_slam_tpu.models import rangenet as jrn
from lis_slam_tpu.ops import pretreatment as jpre, projection as jproj
from lis_slam_tpu.semantic import weights as JW
from lis_slam_torch.config import SemanticConfig, slim_semantic_config
from lis_slam_torch.models import rangenet as rn
from lis_slam_torch.semantic import inference, weights as W

LAYER_RTOL = 1e-5  # float32, same arithmetic: summation order only
FP32_RTOL = 1e-3  # 40 layers of float32 summation-order differences


def _tcfg(jcfg) -> SemanticConfig:
    return SemanticConfig(**dataclasses.asdict(jcfg))


def _rand_tree(tree, rng):
    """`tree` with every leaf redrawn: kernels normal, BN scale/var
    positive, so no kernel is symmetric along the width."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _rand_tree(v, rng)
        elif k in ("scale", "var"):
            out[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        else:
            out[k] = rng.normal(0, 0.3, v.shape).astype(np.float32)
    return out


def test_conv_bn_leaky_strided_same_padding():
    """Flax's "SAME" at stride (1, 2) pads the width by (0, 1)."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(1, 4, 64, 6)).astype(np.float32)
    mod = jrn.ConvBnLeaky(8, strides=(1, 2), dtype=jnp.float32)
    v = mod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    v = _rand_tree(jax.tree_util.tree_map(np.asarray, v), rng)
    want = np.asarray(mod.apply(v, jnp.asarray(x)))

    t = rn.ConvBnLeaky(6, 8, strides=(1, 2), dtype=torch.float32).eval()
    p, s = v["params"], v["batch_stats"]
    state = {f"Conv_0.{k}": a for k, a in
             W.layer_state("conv", p["Conv_0"]).items()}
    state.update({f"BatchNorm_0.{k}": a for k, a in W.layer_state(
        "bn", p["BatchNorm_0"], s["BatchNorm_0"]).items()})
    t.load_state_dict(state)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        got = t(xt).permute(0, 2, 3, 1).numpy()
        sym = torch.nn.functional.leaky_relu(t.BatchNorm_0(
            torch.nn.functional.conv2d(xt, t.Conv_0.weight, stride=(1, 2),
                                       padding=1)), 0.1)
    scale = np.abs(want).max()
    assert got.shape == want.shape == (1, 4, 32, 8)
    assert np.abs(got - want).max() <= LAYER_RTOL * scale
    # the symmetric padding a torch Conv2d(padding=1) would use differs
    assert np.abs(sym.permute(0, 2, 3, 1).numpy() - want).max() > 1e-2 * scale


def test_up_block_unflipped_transpose_kernel():
    """UpBlock (transposed conv, BN, ConvBnLeaky, 1x1 skip projection):
    torch's conv_transpose2d matches flax's only with the kernel flipped
    along the width, which to_torch_state does."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(1, 4, 16, 12)).astype(np.float32)
    skip = rng.normal(size=(1, 4, 32, 5)).astype(np.float32)
    mod = jrn.UpBlock(8, dtype=jnp.float32)
    v = mod.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(skip))
    v = _rand_tree(jax.tree_util.tree_map(np.asarray, v), rng)
    want = np.asarray(mod.apply(v, jnp.asarray(x), jnp.asarray(skip)))

    t = rn.UpBlock(12, 5, 8, dtype=torch.float32).eval()
    p, s = v["params"], v["batch_stats"]
    layers = (("ConvTranspose_0", "deconv"), ("BatchNorm_0", "bn"),
              ("ConvBnLeaky_0.Conv_0", "conv"),
              ("ConvBnLeaky_0.BatchNorm_0", "bn"), ("Conv_0", "conv"))
    state = {}
    for key, kind in layers:
        path = key.split(".")
        pp = p[path[0]] if len(path) == 1 else p[path[0]][path[1]]
        ss = None
        if kind == "bn":
            ss = s[path[0]] if len(path) == 1 else s[path[0]][path[1]]
        state.update({f"{key}.{k}": a for k, a in
                      W.layer_state(kind, pp, ss).items()})
    t.load_state_dict(state)

    def run():
        with torch.no_grad():
            return t(torch.from_numpy(x).permute(0, 3, 1, 2),
                     torch.from_numpy(skip).permute(0, 3, 1, 2)
                     ).permute(0, 2, 3, 1).numpy()

    got = run()
    scale = np.abs(want).max()
    assert got.shape == want.shape == (1, 4, 32, 8)
    assert np.abs(got - want).max() <= LAYER_RTOL * scale
    with torch.no_grad():  # the kernel as flax stores it, unflipped
        t.ConvTranspose_0.weight.copy_(
            t.ConvTranspose_0.weight.flip(-1))
    assert np.abs(run() - want).max() > 1e-2 * scale


@pytest.fixture(scope="module")
def slim_image():
    """A rendered HDL-64 scan's normalized image, 64 x 1800 padded to 1824,
    its mask, and JAX's slim-checkpoint logits in float32 and bf16."""
    jcfg, variables = JW.load_checkpoint()
    scfg = JSensorConfig(max_raw_points=64 * 1800)
    scan = jsyn.render_scan(jsyn.make_world(seed=31),
                            np.array([0, 0, 0.7, 5.0, -3.0, 1.8]), seed=77)
    pre = jpre.pretreat(jnp.asarray(scan.points), jnp.asarray(scan.valid),
                        scfg)
    img, _ = jproj.project_and_extract(
        pre.points[:, :3], pre.points[:, 3], pre.ring, pre.rel_time,
        pre.valid, scfg, want_image=True)
    x = jrn.build_input_image(img.rng, img.xyz, img.intensity, img.mask,
                              jcfg)
    x = np.pad(np.asarray(x), ((0, 0), (0, 24), (0, 0)))[None]
    mask = np.pad(np.asarray(img.mask), ((0, 0), (0, 24)))
    logits = {}
    for fp16 in (False, True):
        c = dataclasses.replace(jcfg, fp16=fp16)
        logits[fp16] = np.asarray(jax.jit(jrn.create_model(c).apply)(
            variables, jnp.asarray(x)))[0]
    return jcfg, x, mask, logits


def _port_logits(jcfg, x, fp16):
    cfg = dataclasses.replace(_tcfg(jcfg), fp16=fp16)
    _, variables = W.load_checkpoint()
    model = inference.load_model(variables, cfg, "cpu")
    with torch.no_grad():
        out = model(torch.from_numpy(x))
    assert out.dtype == torch.float32
    return out[0].numpy()


def test_slim_checkpoint_fp32_logits(slim_image):
    jcfg, x, mask, logits = slim_image
    want = logits[False]
    got = _port_logits(jcfg, x, fp16=False)
    assert got.shape == want.shape == (64, 1824, 20)
    assert np.abs(got - want).max() <= FP32_RTOL * np.abs(want).max()
    agree = (got.argmax(-1) == want.argmax(-1))[mask].mean()
    assert agree >= 0.999, agree


def test_slim_checkpoint_bf16_logits(slim_image):
    jcfg, x, mask, logits = slim_image
    ref32, jax16 = logits[False], logits[True]
    got = _port_logits(jcfg, x, fp16=True)
    agree = (got.argmax(-1) == jax16.argmax(-1))[mask].mean()
    assert agree >= 0.99, agree
    jax_gap = np.abs(jax16 - ref32)[mask].max()
    assert 0 < np.abs(got - ref32)[mask].max() <= 2 * jax_gap


def test_full_size_architecture_on_meta():
    """The released darknet53 (default SemanticConfig): 46,565,940 values
    with batch statistics, every layer in expected_layer_sequence's order
    with the shapes of JAX's eval_shape, 0.63 TFLOP per 64 x 2048 image."""
    cfg = SemanticConfig(enabled=True)
    with torch.device("meta"):
        model = rn.create_model(cfg)
        flops = rn.forward_flops(model, torch.empty(1, 64, 2048, 5))
    state = {k: v for k, v in model.state_dict().items()
             if not k.endswith("num_batches_tracked")}
    assert sum(v.numel() for v in state.values()) == 46_565_940
    kinds = []
    for name, mod in model.named_modules():
        if isinstance(mod, torch.nn.ConvTranspose2d):
            kinds.append((name, "deconv"))
        elif isinstance(mod, torch.nn.Conv2d):
            kinds.append((name, "convb" if mod.bias is not None else "conv"))
        elif isinstance(mod, torch.nn.BatchNorm2d):
            kinds.append((name, "bn"))
    assert kinds == [(p.replace("/", "."), k)
                     for p, k in W.expected_layer_sequence(cfg)]

    jmodel = jrn.create_model(JSemanticConfig(enabled=True))
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 2048, 5)))
    flat = W._flatten(jax.tree_util.tree_map(lambda s: np.zeros(s.shape),
                                             shapes))
    assert sum(v.size for v in flat.values()) == 46_565_940
    mapped = W.to_torch_state(
        {"params": W._unflatten({k[len("params/"):]: v for k, v in
                                 flat.items() if k.startswith("params/")}),
         "batch_stats": W._unflatten(
             {k[len("batch_stats/"):]: v for k, v in flat.items()
              if k.startswith("batch_stats/")})}, cfg)
    assert {k: tuple(v.shape) for k, v in mapped.items()
            if not k.endswith("num_batches_tracked")} == {
        k: tuple(v.shape) for k, v in state.items()}
    assert flops == 626_536_742_912  # 313.3 G multiply-adds


def test_load_checkpoint_matches_jax():
    jcfg, jvars = JW.load_checkpoint()
    tcfg, tvars = W.load_checkpoint()
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    fa = W._flatten(jax.tree_util.tree_map(np.asarray, jvars))
    fb = W._flatten(tvars)
    assert set(fa) == set(fb)
    for k in fa:
        assert fb[k].dtype == fa[k].dtype, k
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


def test_save_checkpoint_round_trip(tmp_path):
    cfg, variables = W.load_checkpoint()
    path = str(tmp_path / "ckpt.npz")
    W.save_checkpoint(path, variables, cfg, meta={"note": "copy"})
    cfg2, v2 = JW.load_checkpoint(path)
    assert dataclasses.asdict(_tcfg(cfg2)) == dataclasses.asdict(cfg)
    fa, fb = W._flatten(variables), W._flatten(
        jax.tree_util.tree_map(np.asarray, v2))
    for k in fa:
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


def _onnx_stream(variables, cfg):
    """The ONNX-style ordered stream of a flax-layout tree (the layout
    transforms of map_ordered_weights reversed)."""

    def get(tree, path):
        for p in path.split("/"):
            tree = tree[p]
        return tree

    entries = []
    for path, kind in W.expected_layer_sequence(cfg):
        p = get(variables["params"], path)
        if kind in ("conv", "convb"):
            e = {"kind": kind, "w": np.transpose(p["kernel"], (3, 2, 0, 1))}
            if kind == "convb":
                e["b"] = p["bias"]
            entries.append(e)
        elif kind == "deconv":
            entries.append({"kind": kind,
                            "w": np.transpose(p["kernel"], (2, 3, 0, 1))})
        else:
            s = get(variables["batch_stats"], path)
            entries.append({"kind": "bn", "scale": p["scale"],
                            "bias": p["bias"], "mean": s["mean"],
                            "var": s["var"]})
    return entries


def test_onnx_layer_order_mapping_roundtrip():
    """tests/test_semantic_infer.py::test_onnx_layer_order_mapping_roundtrip
    for the port: the stream of the port's own init maps back onto the same
    tree (as JAX's map_ordered_weights maps it) with an identical forward
    pass, and a short stream raises."""
    cfg = slim_semantic_config()
    variables = rn.init_params(cfg, torch.Generator().manual_seed(0))
    entries = _onnx_stream(variables, cfg)
    mapped = W.map_ordered_weights(entries, cfg)
    mapped_j = JW.map_ordered_weights(entries, cfg)
    for a, b in ((variables, mapped), (mapped_j, mapped)):
        fa, fb = W._flatten(a), W._flatten(b)
        assert set(fa) == set(fb)
        for k in fa:
            np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)
    x = torch.from_numpy(np.random.default_rng(2).normal(
        size=(1, 64, 64, 5)).astype(np.float32))
    outs = []
    for v in (variables, mapped):
        with torch.no_grad():
            outs.append(inference.load_model(v, cfg, "cpu")(x))
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)
    with pytest.raises(ValueError):
        W.map_ordered_weights(entries[:-1], cfg)
    with pytest.raises(ValueError):
        W.map_ordered_weights(entries[1:] + entries[:1], cfg)


def test_onnx_deconv_kernel_is_not_flipped():
    """Both packages carry an ONNX ConvTranspose kernel into the flax
    layout unflipped, so the port's F.conv_transpose2d runs it mirrored
    along the width: an ONNX (I, O, kH, kW) kernel comes out of
    to_torch_state as its flip, where ONNX's own semantics (those of
    F.conv_transpose2d) would need it as it is."""
    cfg = slim_semantic_config()
    variables = rn.init_params(cfg, torch.Generator().manual_seed(1))
    entries = _onnx_stream(variables, cfg)
    state = W.to_torch_state(W.map_ordered_weights(entries, cfg), cfg)
    state_j = W.to_torch_state(JW.map_ordered_weights(entries, cfg), cfg)
    n_deconv = 0
    for (path, kind), e in zip(W.expected_layer_sequence(cfg), entries):
        if kind != "deconv":
            continue
        n_deconv += 1
        w = state[path.replace("/", ".") + ".weight"].numpy()
        np.testing.assert_array_equal(w, e["w"][..., ::-1])
        np.testing.assert_array_equal(
            w, state_j[path.replace("/", ".") + ".weight"].numpy())
        assert not np.array_equal(w, e["w"])
    assert n_deconv == len(cfg.dec_widths)


def test_init_params_follows_flax_scheme():
    """lecun-normal truncated kernels (std sqrt(1/fan_in) within 2 sigma
    of the untruncated scale), BatchNorm 1/0/0/1, head bias 0; the same
    tree structure as JAX's init; reproducible from the generator."""
    cfg = slim_semantic_config()
    a = rn.init_params(cfg, torch.Generator().manual_seed(3))
    b = rn.init_params(cfg, torch.Generator().manual_seed(3))
    _, jv = jrn.init_params(jax.random.PRNGKey(0), JSemanticConfig(
        **dataclasses.asdict(cfg)), input_w=64)
    fj = W._flatten(jax.tree_util.tree_map(np.asarray, jv))
    fa, fb = W._flatten(a), W._flatten(b)
    assert set(fa) == set(fj)
    for k in fa:
        assert fa[k].shape == fj[k].shape and fa[k].dtype == np.float32, k
        np.testing.assert_array_equal(fa[k], fb[k])
        if k.endswith("kernel"):
            fan_in = int(np.prod(fa[k].shape[:-1]))
            std = np.sqrt(1.0 / fan_in)
            assert np.abs(fa[k]).max() <= 2 * std / 0.87962566103423978 + 1e-6
            if fa[k].size > 2000:
                assert abs(fa[k].std() / std - 1) < 0.1, k
        elif k.endswith(("scale", "var")):
            assert (fa[k] == 1).all()
        else:
            assert (fa[k] == 0).all(), k
