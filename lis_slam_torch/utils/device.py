"""The device the port's entry points run on.

`replay_odometry`, `LioOdometry`, `SemanticSlam` and the initial-state
functions (`odometry.init_state`, `semantic_odometry.init_state`,
`slam.init_fused_state`) default to "cuda". Without a CUDA device they
raise here instead of carrying on on the host; the CPU path (the kernels'
plain versions) runs only when the caller passes device="cpu".
"""

from __future__ import annotations

import torch


def resolve(device: torch.device | str) -> torch.device:
    """`device` as a torch.device; a CUDA device that this machine lacks
    raises RuntimeError."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested, but CUDA is not available; "
            "pass device='cpu' to run the port on the host")
    return dev
