"""RangeNet weights drawn from a seed, for the architecture of
`cfg.semantic` (darknet53 at its published widths by default), in the
layout `SemanticSlam(rangenet_params=...)` takes: the flax-layout tree
{"params", "batch_stats"} of float32 host arrays.

Every kernel is lecun-normal (truncated at 2 sigma, fan-in kH kW I), as
flax initializes it; the class head's bias 0; BatchNorm scale 1, bias 0,
mean 0, var 1. All kernels come from one draw of standard truncated
normals on `device` from a generator seeded with `seed`, scaled layer by
layer and copied to the host once. Random weights label the scan at
random: enough to time the network and to hold the program to a
reference on the same weights, not to segment."""

from __future__ import annotations

import math

import numpy as np
import torch


def build(cfg, seed: int, device) -> dict:
    from lis_slam_torch.models import rangenet

    sem = cfg.semantic
    with torch.device("meta"):
        shapes = {k: tuple(v.shape)
                  for k, v in rangenet.create_model(sem).state_dict().items()}
    layers = rangenet.expected_layer_sequence(sem)
    kernels = []  # (path, kind, HWIO shape)
    for path, kind in layers:
        w = shapes[path.replace("/", ".") + ".weight"]
        if kind in ("conv", "convb"):
            o, i, kh, kw = w
            kernels.append((path, kind, (kh, kw, i, o)))
        elif kind == "deconv":
            i, o, kh, kw = w
            kernels.append((path, kind, (kh, kw, i, o)))
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    z = torch.empty(sum(math.prod(s) for _p, _k, s in kernels),
                    device=device)
    torch.nn.init.trunc_normal_(z, 0.0, 1.0, -2.0, 2.0, generator=gen)
    z = z.cpu().numpy()
    params, stats = {}, {}

    def put(tree, path, leaf, value):
        node = tree
        for p in path.split("/"):
            node = node.setdefault(p, {})
        node[leaf] = value

    off = 0
    for path, kind, shape in kernels:
        n = math.prod(shape)
        # the standard deviation of lecun-normal truncated at 2 sigma
        std = math.sqrt(1.0 / math.prod(shape[:-1])) / 0.87962566103423978
        put(params, path, "kernel",
            (z[off:off + n] * np.float32(std)).reshape(shape))
        if kind == "convb":
            put(params, path, "bias", np.zeros(shape[-1], np.float32))
        off += n
    for path, kind in layers:
        if kind == "bn":
            c = shapes[path.replace("/", ".") + ".weight"][0]
            put(params, path, "scale", np.ones(c, np.float32))
            put(params, path, "bias", np.zeros(c, np.float32))
            put(stats, path, "mean", np.zeros(c, np.float32))
            put(stats, path, "var", np.ones(c, np.float32))
    return {"params": params, "batch_stats": stats}
