"""Odometry state to and from plain numpy dictionaries.

Field names are those of the JAX `OdomState`
(lis_slam_tpu/pipeline/odometry.py), so a state produced by either package
can start the other: `{f: np.asarray(v) for f, v in jax_state._asdict()
.items()}` goes in, and `odom_state_to_numpy` gives the same layout back.
"""

from __future__ import annotations

import numpy as np
import torch

from .odometry import OdomState

_INT32 = ("frame_idx", "kf_count", "kf_head", "map_corner_age",
          "map_surf_age")
_BOOL = ("map_corner_mask", "map_surf_mask")


def _dtype(field: str):
    if field in _INT32:
        return np.int32
    return np.bool_ if field in _BOOL else np.float32


def odom_state_from_numpy(arrays: dict, device: torch.device | str = "cpu"
                          ) -> OdomState:
    """OdomState on `device` from a dict of arrays keyed by field name."""
    return OdomState(**{
        f: torch.from_numpy(np.array(arrays[f], dtype=_dtype(f))).to(device)
        for f in OdomState._fields})


def odom_state_to_numpy(state: OdomState) -> dict:
    """Dict of numpy arrays keyed by field name."""
    return {f: getattr(state, f).detach().cpu().numpy()
            for f in OdomState._fields}
