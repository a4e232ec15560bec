"""`rangenet_seeded`'s weights loaded once into the program's RangeNet on
the device: the module, which `SemanticSlam(rangenet_params=...)` uses as
given. Every session of a process then shares one net, and with it the
CUDA graph of its keyframe labelling, as a deployment's node loads its
net once; a tree handed to each session is loaded by each."""

from __future__ import annotations

import torch

from perfbench.weights import rangenet_seeded


def build(cfg, seed: int, device):
    from lis_slam_torch.models import rangenet
    from lis_slam_torch.semantic import weights

    tree = rangenet_seeded.build(cfg, seed, device)
    with torch.device(device):
        model = rangenet.create_model(cfg.semantic)
    model.load_state_dict(weights.to_torch_state(tree, cfg.semantic))
    return model
