"""Odometry and LIO state to and from plain numpy dictionaries.

Field names are those of the JAX package's `OdomState`, `ImuState` and
`PreintegratedImu` (lis_slam_tpu/pipeline/odometry.py,
lis_slam_tpu/imu/preintegration.py), so a state produced by either package
can start the other: `{f: np.asarray(v) for f, v in jax_state._asdict()
.items()}` goes in, and the `*_to_numpy` functions give the same layout
back. A LIO snapshot (`lio_to_numpy`) holds a whole `LioOdometry` run.
"""

from __future__ import annotations

import numpy as np
import torch

from ..imu import preintegration as pi
from .lio import LioOdometry
from .odometry import OdomState

_INT32 = ("frame_idx", "kf_count", "kf_head", "map_corner_age",
          "map_surf_age")
_BOOL = ("map_corner_mask", "map_surf_mask")
_HOST = dict(dtype=torch.float64, device="cpu")


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


def _host(a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float64), **_HOST)


def imu_state_from_numpy(arrays: dict) -> pi.ImuState:
    """Host float64 ImuState from a dict of arrays keyed by field name."""
    return pi.ImuState(**{f: _host(arrays[f]) for f in pi.ImuState._fields})


def imu_state_to_numpy(state: pi.ImuState) -> dict:
    return {f: getattr(state, f).cpu().numpy() for f in pi.ImuState._fields}


def preintegrated_from_numpy(arrays: dict) -> pi.PreintegratedImu:
    """Host float64 PreintegratedImu from a dict of arrays."""
    return pi.PreintegratedImu(**{
        f: int(arrays[f]) if f == "count" else _host(arrays[f])
        for f in pi.PreintegratedImu._fields})


def preintegrated_to_numpy(pre: pi.PreintegratedImu) -> dict:
    return {f: (np.int32(v) if f == "count" else v.cpu().numpy())
            for f, v in pre._asdict().items()}


def lio_to_numpy(lio) -> dict:
    """Snapshot of a LioOdometry: the odometry state, the IMU state and
    the driver's window pair, velocity, latch and counters."""
    def opt(x, fn):
        return None if x is None else fn(x)

    win = lio._prev_win
    return dict(
        state=odom_state_to_numpy(lio.state),
        imu_state=imu_state_to_numpy(lio.imu_state),
        prev_pre=opt(lio._prev_pre, preintegrated_to_numpy),
        prev_pose6=opt(lio._prev_pose6, lambda t: t.cpu().numpy()),
        v0=lio._v0.cpu().numpy(),
        prev_win=opt(win, lambda w: (w[0].numpy(), w[1].numpy(),
                                     w[2].numpy(), w[3].numpy(),
                                     np.float32(w[4]))),
        last_pose6=opt(lio._last_pose6, lambda t: t.cpu().numpy()),
        fail_acc=bool(lio._fail_acc),
        n_resets=lio.diag.n_resets, n_scans=lio.diag.n_scans)


def lio_from_numpy(snap: dict, cfg, device: torch.device | str = "cpu"):
    """A LioOdometry that continues the run of a snapshot (lio_to_numpy's
    layout, or the same built from the JAX package's LioOdometry)."""
    def opt(x, fn):
        return None if x is None else fn(x)

    lio = LioOdometry(cfg, device)
    lio.state = odom_state_from_numpy(snap["state"], device)
    lio.imu_state = imu_state_from_numpy(snap["imu_state"])
    lio._prev_pre = opt(snap["prev_pre"], preintegrated_from_numpy)
    lio._prev_pose6 = opt(snap["prev_pose6"], _host)
    lio._v0 = _host(snap["v0"])
    lio._prev_win = opt(snap["prev_win"], lambda w: (
        _host(w[0]), _host(w[1]), _host(w[2]),
        torch.from_numpy(np.array(w[3], bool)), float(np.float32(w[4]))))
    lio._last_pose6 = opt(snap["last_pose6"], _host)
    lio._fail_acc = bool(snap["fail_acc"])
    lio.diag.n_resets = int(snap["n_resets"])
    lio.diag.n_scans = int(snap["n_scans"])
    return lio
