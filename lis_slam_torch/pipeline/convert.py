"""Odometry, LIO and full-SLAM state to and from plain numpy dictionaries.

Field names are those of the JAX package's `OdomState`, `ImuState`,
`PreintegratedImu`, `SemanticOdomState` and `FusedState`
(lis_slam_tpu/pipeline/odometry.py, imu/preintegration.py,
pipeline/semantic_odometry.py, pipeline/slam.py), so a state produced by
either package can start the other: `{f: np.asarray(v) for f, v in
jax_state._asdict().items()}` goes in, and the `*_to_numpy` functions give
the same layout back (`odom_states_*` for the lanes of batched replay). A
LIO snapshot (`lio_to_numpy`) holds a whole
`LioOdometry` run. The host state of the back end (`LoopDetector`,
`SubMapCollector` with its keyframes, `GraphBuilder`) has snapshots too;
the JAX objects carry the same attributes, so `loop_detector_to_numpy`
etc. read either package's object.
"""

from __future__ import annotations

import numpy as np
import torch

from ..imu import preintegration as pi
from .lio import LioOdometry
from .odometry import OdomState

_INT32 = ("frame_idx", "kf_count", "kf_head", "map_corner_age",
          "map_surf_age", "corner_age", "surf_age")
_BOOL = ("map_corner_mask", "map_surf_mask", "corner_mask", "surf_mask",
         "surf_dyn")
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


def odom_states_from_numpy(lanes: list, device: torch.device | str = "cpu"
                           ) -> OdomState:
    """Lanes of an OdomState (parallel/batched.py) on `device` from one
    dict of arrays per lane, e.g. one JAX state per sequence, or from a
    batched JAX state's dict cut by lane."""
    return odom_state_from_numpy(
        {f: np.stack([np.asarray(a[f], dtype=_dtype(f)) for a in lanes])
         for f in OdomState._fields}, device)


def odom_states_to_numpy(state: OdomState) -> list:
    """One dict of numpy arrays per lane of a lanes OdomState."""
    arrays = odom_state_to_numpy(state)
    return [{f: a[b] for f, a in arrays.items()}
            for b in range(state.pose.shape[0])]


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


# ---------------------------------------------------------------------------
# full SLAM
# ---------------------------------------------------------------------------


def _np(x):
    return None if x is None else np.asarray(
        x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x)


def _dev(a, device, dtype=None):
    if a is None:
        return None
    return torch.from_numpy(np.array(a, dtype=dtype)).to(device)


def sem_state_from_numpy(arrays: dict, device: torch.device | str = "cpu"):
    """SemanticOdomState on `device` from a dict keyed by field name."""
    from .semantic_odometry import SemanticOdomState

    return SemanticOdomState(**{
        f: _dev(arrays[f], device, _dtype(f))
        for f in SemanticOdomState._fields})


def sem_state_to_numpy(state) -> dict:
    return {f: _np(getattr(state, f)) for f in state._fields}


# the JAX FusedState's IMU fields (cfg.imu.use_imu), besides imu/prev_pre
_IMU_ARRAYS = ("imu_pose0", "imu_v0", "prev_imu_time", "prev_imu_gyro",
               "prev_imu_accel")
_IMU_FLAGS = ("imu_have_prev", "imu_fail")


def fused_state_from_numpy(snap: dict, device: torch.device | str = "cpu"):
    """FusedState from {"odom": {...}, "sem": {...}, "last_frontend",
    "last_refined", "imu": None or the IMU fields} (fused_state_to_numpy's
    layout). The IMU fields go to the host in float64."""
    from .slam import FusedState

    odom = odom_state_from_numpy(snap["odom"], device)
    imu = {}
    if snap.get("imu") is not None:
        d = snap["imu"]
        imu = dict(imu=imu_state_from_numpy(d["imu"]),
                   prev_pre=preintegrated_from_numpy(d["prev_pre"]),
                   prev_imu_valid=torch.from_numpy(
                       np.array(d["prev_imu_valid"], bool)),
                   prev_scan_start=float(np.float32(d["prev_scan_start"])),
                   odom_pose_host=_host(snap["odom"]["pose"]),
                   **{f: _host(d[f]) for f in _IMU_ARRAYS},
                   **{f: bool(d[f]) for f in _IMU_FLAGS})
    return FusedState(
        odom=odom, sem=sem_state_from_numpy(snap["sem"], device),
        last_frontend=_dev(snap["last_frontend"], device, np.float32),
        last_refined=_dev(snap["last_refined"], device, np.float32), **imu)


def fused_state_to_numpy(fstate) -> dict:
    """The layout of fused_state_from_numpy, from either package's
    FusedState; "imu" is None without the IMU fields."""
    imu = None
    if getattr(fstate, "imu", None) is not None:
        imu = dict(imu={f: _np(v) for f, v in fstate.imu._asdict().items()},
                   prev_pre={f: _np(v) for f, v in
                             fstate.prev_pre._asdict().items()},
                   prev_imu_valid=_np(fstate.prev_imu_valid).astype(bool),
                   prev_scan_start=np.float32(_np(fstate.prev_scan_start)),
                   **{f: _np(getattr(fstate, f)) for f in _IMU_ARRAYS},
                   **{f: bool(_np(getattr(fstate, f))) for f in _IMU_FLAGS})
    return dict(odom={f: _np(getattr(fstate.odom, f))
                      for f in OdomState._fields},
                sem=sem_state_to_numpy(fstate.sem),
                last_frontend=_np(fstate.last_frontend),
                last_refined=_np(fstate.last_refined), imu=imu)


def loop_detector_to_numpy(det) -> dict:
    return dict(descs=[_np(d) for d in det.descs],
                sigs=[_np(s) for s in det.sigs],
                poses=[np.asarray(p) for p in det.poses],
                travel=list(det.travel), n_stored=int(det._n_stored))


def loop_detector_from_numpy(snap: dict, cfg,
                             device: torch.device | str = "cpu"):
    from ..loop.epsc import LoopDetector

    det = LoopDetector(cfg)
    det.descs = [_dev(d, device, np.float32) for d in snap["descs"]]
    det.sigs = [_dev(s, device, np.float32) for s in snap["sigs"]]
    det.poses = [np.asarray(p, np.float64) for p in snap["poses"]]
    det.travel = [float(t) for t in snap["travel"]]
    det._n_stored = int(snap["n_stored"])
    return det


_KF_CLOUDS = ("corner_xyz", "corner_mask", "surf_xyz", "surf_mask")
_SUBMAP_CLOUDS = _KF_CLOUDS + ("class_xyz", "class_mask", "class_w",
                               "bbox_dev")


def keyframe_to_numpy(kf) -> dict:
    c = kf.clouds
    return dict(index=kf.index, pose_init=np.asarray(kf.pose_init),
                pose_opt=np.asarray(kf.pose_opt), submap_id=kf.submap_id,
                timestamp=kf.timestamp,
                clouds=None if c is None else (_np(c.xyz), _np(c.mask),
                                               _np(c.w)),
                **{f: _np(getattr(kf, f)) for f in _KF_CLOUDS})


def keyframe_from_numpy(d: dict, device: torch.device | str = "cpu"):
    from ..mapping.submap import ClassClouds, Keyframe

    c = d["clouds"]
    return Keyframe(
        index=int(d["index"]), pose_init=np.asarray(d["pose_init"]),
        pose_opt=np.asarray(d["pose_opt"]),
        clouds=None if c is None else ClassClouds(*(_dev(a, device)
                                                    for a in c)),
        submap_id=int(d["submap_id"]), timestamp=float(d["timestamp"]),
        **{f: _dev(d[f], device) for f in _KF_CLOUDS})


def collector_to_numpy(col) -> dict:
    """SubMapCollector: its submaps, accumulators, and the open submap's
    keyframes by index (the keyframes themselves are snapshotted by the
    caller, keyframe_to_numpy)."""
    subs = [dict(index=s.index, pose_init=np.asarray(s.pose_init),
                 pose_opt=np.asarray(s.pose_opt),
                 kf_indices=list(s.kf_indices),
                 kf_rel_poses=[np.asarray(r) for r in s.kf_rel_poses],
                 bbox=None if s.bbox is None else np.asarray(s.bbox),
                 **{f: _np(getattr(s, f)) for f in _SUBMAP_CLOUDS})
            for s in col.submaps]
    return dict(submaps=subs, accu_tran=col.accu_tran,
                accu_rot=col.accu_rot, accu_frame=col.accu_frame,
                cur_kfs=[kf.index for kf in col._cur_kfs],
                last_pose=_np(col._last_pose),
                merge_classes=bool(col.merge_classes))


def collector_from_numpy(snap: dict, cfg, keyframes: list,
                         device: torch.device | str = "cpu"):
    """A SubMapCollector whose open submap holds `keyframes[i]` for the
    snapshot's indices (the same objects the pipeline keeps)."""
    from ..mapping.submap import SubMap, SubMapCollector

    col = SubMapCollector(cfg)
    col.submaps = [SubMap(
        index=int(s["index"]), pose_init=np.asarray(s["pose_init"]),
        pose_opt=np.asarray(s["pose_opt"]), kf_indices=list(s["kf_indices"]),
        kf_rel_poses=[np.asarray(r) for r in s["kf_rel_poses"]],
        bbox=s["bbox"], **{f: _dev(s[f], device) for f in _SUBMAP_CLOUDS})
        for s in snap["submaps"]]
    col.accu_tran = float(snap["accu_tran"])
    col.accu_rot = float(snap["accu_rot"])
    col.accu_frame = int(snap["accu_frame"])
    col._cur_kfs = [keyframes[i] for i in snap["cur_kfs"]]
    col._last_pose = snap["last_pose"]
    col.merge_classes = bool(snap["merge_classes"])
    return col


def graph_builder_to_numpy(gb) -> dict:
    return dict(nodes=[np.asarray(n) for n in gb.nodes],
                edges=[(int(i), int(j), np.asarray(z), np.asarray(w),
                        bool(r)) for (i, j, z, w, r) in gb.edges],
                priors=[(int(i), np.asarray(z), np.asarray(w))
                        for (i, z, w) in gb.priors])


def graph_builder_from_numpy(snap: dict, gb):
    """Load a snapshot into an existing GraphBuilder (its capacities and
    device stay)."""
    gb.nodes = [np.asarray(n, np.float32) for n in snap["nodes"]]
    gb.edges = [tuple(e) for e in snap["edges"]]
    gb.priors = [tuple(p) for p in snap["priors"]]
    return gb
