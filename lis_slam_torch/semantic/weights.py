"""RangeNet checkpoint save/load (npz), the ONNX layer-order importer, and
the carry-over of a flax-layout weight tree onto the port's `RangeNet`
(port of lis_slam_tpu/semantic/weights.py).

Trees stay in the JAX package's flax layout ({'params': ...,
'batch_stats': ...}, '/'-joined module paths, HWIO kernels) as numpy
arrays, so one tree drives both packages; `to_torch_state` maps it onto
`models.rangenet.RangeNet.state_dict()`.

Format: flat npz of params (float16) + batch_stats (float32), keys are
'/'-joined pytree paths, plus a JSON header with the SemanticConfig fields
the architecture depends on. The in-repo checkpoint
(weights/rangenet_synthetic_slim.npz) is a byte-for-byte copy of the JAX
package's, a slim RangeNet trained on the synthetic world.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..config import SemanticConfig
from ..models.rangenet import expected_layer_sequence

DEFAULT_CHECKPOINT = os.path.join(
    os.path.dirname(__file__), "..", "weights", "rangenet_synthetic_slim.npz"
)


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(_flatten(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def _unflatten(flat):
    tree: dict = {}
    for key, v in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def save_checkpoint(path: str, variables: dict, cfg: SemanticConfig,
                    meta: dict | None = None):
    """variables = {'params': ..., 'batch_stats': ...} (flax format)."""
    flat = {}
    for k, v in _flatten(variables["params"], "params").items():
        flat[k] = v.astype(np.float16)
    for k, v in _flatten(variables.get("batch_stats", {}), "batch_stats").items():
        flat[k] = v.astype(np.float32)
    header = {
        "num_classes": cfg.num_classes,
        "enc_blocks": list(cfg.enc_blocks),
        "enc_widths": list(cfg.enc_widths),
        "dec_widths": list(cfg.dec_widths),
        "img_means": list(cfg.img_means),
        "img_stds": list(cfg.img_stds),
        **(meta or {}),
    }
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(path, __meta__=json.dumps(header), **flat)


def load_checkpoint(path: str | None = None):
    """Returns (SemanticConfig, variables): the flax-layout tree as numpy,
    float16 params widened to float32.

    Raises FileNotFoundError if no checkpoint exists at `path` (or the
    default in-repo location)."""
    path = path or DEFAULT_CHECKPOINT
    data = np.load(path, allow_pickle=False)
    meta = json.loads(str(data["__meta__"]))
    cfg = SemanticConfig(
        enabled=True,
        num_classes=int(meta["num_classes"]),
        enc_blocks=tuple(meta["enc_blocks"]),
        enc_widths=tuple(meta["enc_widths"]),
        dec_widths=tuple(meta["dec_widths"]),
        img_means=tuple(meta["img_means"]),
        img_stds=tuple(meta["img_stds"]),
    )
    flat = {}
    for k in data.files:
        if k == "__meta__":
            continue
        arr = data[k]
        flat[k] = arr.astype(np.float32) if arr.dtype == np.float16 else arr
    tree = _unflatten(flat)
    variables = {"params": tree.get("params", {})}
    if "batch_stats" in tree:
        variables["batch_stats"] = tree["batch_stats"]
    return cfg, variables


def map_ordered_weights(entries, cfg: SemanticConfig):
    """Map an ordered ONNX-style weight stream onto the flax-layout tree.

    `entries`: list of dicts in graph order, each one of
      {'kind': 'conv',   'w': (O, I, kH, kW)}
      {'kind': 'deconv', 'w': (I, O, kH, kW)}          (ONNX ConvTranspose)
      {'kind': 'convb',  'w': (O, I, kH, kW), 'b': (O,)}
      {'kind': 'bn',     'scale': g, 'bias': b, 'mean': m, 'var': v}
    Returns `variables` = {'params': ..., 'batch_stats': ...}.

    As in the JAX package, the ONNX ConvTranspose kernel is carried into
    the flax layout WITHOUT a flip, although flax's ConvTranspose (as
    RangeNet uses it) does not flip its kernel and ONNX's does: a released
    decoder would come out mirrored along the width. Kept identical to the
    JAX package on purpose (tests/test_torch_rangenet.py pins it)."""
    seq = expected_layer_sequence(cfg)
    if len(entries) != len(seq):
        raise ValueError(
            f"weight stream has {len(entries)} layer groups, architecture "
            f"expects {len(seq)} — architecture/config mismatch")
    params: dict = {}
    stats: dict = {}

    def put(tree, path, leaf, value):
        node = tree
        for p in path.split("/"):
            node = node.setdefault(p, {})
        node[leaf] = np.asarray(value)

    for (path, kind), e in zip(seq, entries):
        if e["kind"] != kind:
            raise ValueError(f"at {path}: expected {kind}, got {e['kind']}")
        if kind in ("conv", "convb"):
            w = np.transpose(np.asarray(e["w"]), (2, 3, 1, 0))  # OIHW->HWIO
            put(params, path, "kernel", w)
            if kind == "convb":
                put(params, path, "bias", np.asarray(e["b"]))
        elif kind == "deconv":
            # ONNX ConvTranspose stores (I, O, kH, kW); flax wants
            # (kH, kW, I, O)
            w = np.transpose(np.asarray(e["w"]), (2, 3, 0, 1))
            put(params, path, "kernel", w)
        else:  # bn
            put(params, path, "scale", np.asarray(e["scale"]))
            put(params, path, "bias", np.asarray(e["bias"]))
            put(stats, path, "mean", np.asarray(e["mean"]))
            put(stats, path, "var", np.asarray(e["var"]))
    return {"params": params, "batch_stats": stats}


def load_onnx(path: str, cfg: SemanticConfig):
    """Importer for the released RangeNet++ ONNX weights (the reference
    downloads darknet53.onnx; netTensorRT.cpp:491-676 builds a TensorRT
    engine from it). Extracts the conv/BN initializer stream in graph order
    and maps it via `map_ordered_weights`. Requires the `onnx` package."""
    try:
        import onnx
    except ImportError as e:
        raise NotImplementedError(
            "onnx is not installed in this environment; use the synthetic "
            "checkpoint (semantic/weights.py:DEFAULT_CHECKPOINT) instead"
        ) from e
    model = onnx.load(path)
    init = {t.name: onnx.numpy_helper.to_array(t)
            for t in model.graph.initializer}
    entries = []
    for node in model.graph.node:
        if node.op_type == "Conv":
            w = init[node.input[1]]
            if len(node.input) > 2:  # biased conv = the class head
                entries.append({"kind": "convb", "w": w,
                                "b": init[node.input[2]]})
            else:
                entries.append({"kind": "conv", "w": w})
        elif node.op_type == "ConvTranspose":
            entries.append({"kind": "deconv", "w": init[node.input[1]]})
        elif node.op_type == "BatchNormalization":
            entries.append({
                "kind": "bn",
                "scale": init[node.input[1]], "bias": init[node.input[2]],
                "mean": init[node.input[3]], "var": init[node.input[4]],
            })
    return map_ordered_weights(entries, cfg)


def to_torch_state(variables: dict, cfg: SemanticConfig
                   ) -> dict[str, torch.Tensor]:
    """The flax-layout tree as `RangeNet(cfg).state_dict()`: the port's
    submodules carry flax's scope names, so a '/'-joined path becomes a
    '.'-joined key. Conv HWIO kernels become OIHW; a ConvTranspose kernel
    (kH, kW, I, O) becomes torch's (I, O, kH, kW) FLIPPED along kW,
    because flax's ConvTranspose does not flip its kernel and
    F.conv_transpose2d does; BatchNorm scale/bias/mean/var become
    weight/bias/running_mean/running_var. Float32 throughout (the module
    casts to its compute dtype on load)."""
    params, stats = variables["params"], variables.get("batch_stats", {})

    def node(tree, path):
        for p in path.split("/"):
            tree = tree[p]
        return tree

    state = {}
    for path, kind in expected_layer_sequence(cfg):
        key = path.replace("/", ".")
        s = node(stats, path) if kind == "bn" else None
        for leaf, v in layer_state(kind, node(params, path), s).items():
            state[f"{key}.{leaf}"] = v
    return state


def layer_state(kind: str, params: dict, stats: dict | None = None
                ) -> dict[str, torch.Tensor]:
    """One layer of `to_torch_state`: its flax leaves (`kind` as in
    expected_layer_sequence) as the torch module's state."""

    def t(a):
        return torch.from_numpy(np.array(a, dtype=np.float32, order="C"))

    if kind in ("conv", "convb"):
        out = {"weight": t(np.transpose(params["kernel"], (3, 2, 0, 1)))}
        if kind == "convb":
            out["bias"] = t(params["bias"])
        return out
    if kind == "deconv":
        k = np.transpose(params["kernel"], (2, 3, 0, 1))[..., ::-1]
        return {"weight": t(k)}
    return {"weight": t(params["scale"]), "bias": t(params["bias"]),
            "running_mean": t(stats["mean"]), "running_var": t(stats["var"]),
            "num_batches_tracked": torch.zeros((), dtype=torch.long)}
