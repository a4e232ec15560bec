"""Checkpoint / resume for the SLAM engine (port of
lis_slam_tpu/runtime/checkpoint.py; the reference has no mid-run
persistence, SURVEY.md section 5).

The file format is the JAX module's, key for key: one compressed .npz with
a `__meta__` JSON header ("version": 3 for a full system). A state's
leaves are stored as `<tag>_<i>` in the order jax.tree_util.tree_flatten
gives them, which for the flat NamedTuples here is field order with None
fields dropped. A checkpoint written by either package loads into the
other.

As in the JAX module, a full-system checkpoint holds the odometry and
semantic device states, `last_refined`/`last_frontend` of the fused state,
the per-scan poses, keyframes (without the clouds of released ones),
submaps, the pose graph, the loop detector's database and the pending
verified loops. The IMU fields of the fused state (cfg.imu.use_imu) are
not saved: a resumed LIO run re-anchors its nav state as after a reset.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from ..mapping import submap as sm


def _leaves(tree) -> list[torch.Tensor]:
    """A state's tensor fields in field order, None dropped: the order of
    jax.tree_util.tree_flatten on the JAX NamedTuple."""
    return [v for v in tree if v is not None]


def _rebuild(template, arrays, device):
    """`template` with its tensor fields taken in order from the iterator
    `arrays`, each on `device` in the template field's dtype."""
    return type(template)(*(
        None if v is None else torch.from_numpy(np.array(
            next(arrays), copy=True)).to(device=device, dtype=v.dtype)
        for v in template))


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def save_odom_state(path: str, state, extra: dict | None = None):
    arrs = {f"leaf_{i}": _np(x) for i, x in enumerate(_leaves(state))}
    meta = {"n_leaves": len(arrs)}
    if extra:
        meta["extra"] = extra
    np.savez_compressed(path, __meta__=json.dumps(meta), **arrs)


def load_odom_state(path: str, template) -> tuple:
    """Returns (state, extra). `template` gives the structure, dtypes and
    device (odometry.init_state with the same config)."""
    data = np.load(path, allow_pickle=False)
    meta = json.loads(str(data["__meta__"]))
    leaves = _leaves(template)
    assert meta["n_leaves"] == len(leaves), "config/capacity mismatch"
    state = _rebuild(template, (data[f"leaf_{i}"]
                                for i in range(len(leaves))),
                     template.pose.device)
    return state, meta.get("extra", {})


def save_slam(path: str, system) -> None:
    """Full-system checkpoint of a pipeline.slam.SemanticSlam, after
    draining its deferred queues (flush_pipeline)."""
    system.flush_pipeline()

    arrs: dict[str, np.ndarray] = {}
    meta: dict = {"version": 3}

    for tag, tree in (("odom", system.state), ("sem", system.sem_state)):
        leaves = _leaves(tree)
        meta[f"n_{tag}"] = len(leaves)
        for i, x in enumerate(leaves):
            arrs[f"{tag}_{i}"] = _np(x)

    arrs["scan_poses"] = np.asarray(system.scan_poses).reshape(-1, 6)
    arrs["kf_scan_ids"] = np.asarray(system.kf_scan_ids, np.int64)
    meta["scan_idx"] = system._scan_idx
    meta["n_loop_factors"] = system._n_loop_factors
    # submap pairs already holding a loop factor: the resumed dedup
    meta["loop_pairs"] = sorted([list(p) for p in system._loop_pairs])
    meta["merge_classes"] = bool(system.collector.merge_classes)
    arrs["last_refined"] = _np(system.fstate.last_refined)
    arrs["last_frontend"] = _np(system.fstate.last_frontend)

    # buffered GPS fixes not yet drained into a submap
    meta["n_gps"] = len(system._gps_queue)
    for k, (t, pos, cov) in enumerate(system._gps_queue):
        arrs[f"gps{k}"] = np.concatenate([[t], pos, cov])

    # keyframes; released ones (submap.Keyframe.release_clouds) keep
    # their poses only
    meta["n_kf"] = len(system.keyframes)
    for k, kf in enumerate(system.keyframes):
        arrs[f"kf{k}_pose_init"] = kf.pose_init
        arrs[f"kf{k}_pose_opt"] = kf.pose_opt
        if not kf.released:
            arrs[f"kf{k}_corner"] = _np(kf.corner_xyz)
            arrs[f"kf{k}_corner_m"] = _np(kf.corner_mask)
            arrs[f"kf{k}_surf"] = _np(kf.surf_xyz)
            arrs[f"kf{k}_surf_m"] = _np(kf.surf_mask)
            arrs[f"kf{k}_cls"] = _np(kf.clouds.xyz)
            arrs[f"kf{k}_cls_m"] = _np(kf.clouds.mask)
            if kf.clouds.w is not None:
                arrs[f"kf{k}_cls_w"] = _np(kf.clouds.w)
        arrs[f"kf{k}_t"] = np.float64(kf.timestamp)
        arrs[f"kf{k}_sid"] = np.int64(kf.submap_id)

    meta["n_sm"] = len(system.collector.submaps)
    for k, s in enumerate(system.collector.submaps):
        arrs[f"sm{k}_pose_init"] = s.pose_init
        arrs[f"sm{k}_pose_opt"] = s.pose_opt
        arrs[f"sm{k}_corner"] = _np(s.corner_xyz)
        arrs[f"sm{k}_corner_m"] = _np(s.corner_mask)
        arrs[f"sm{k}_surf"] = _np(s.surf_xyz)
        arrs[f"sm{k}_surf_m"] = _np(s.surf_mask)
        if s.class_xyz is not None:
            arrs[f"sm{k}_cls"] = _np(s.class_xyz)
            arrs[f"sm{k}_cls_m"] = _np(s.class_mask)
            if s.class_w is not None:
                arrs[f"sm{k}_cls_w"] = _np(s.class_w)
        arrs[f"sm{k}_kf_idx"] = np.asarray(s.kf_indices, np.int64)
        arrs[f"sm{k}_kf_rel"] = np.asarray(s.kf_rel_poses).reshape(-1, 4, 4)
    col = system.collector
    meta["col"] = {"accu_tran": col.accu_tran, "accu_rot": col.accu_rot,
                   "accu_frame": col.accu_frame,
                   "open_kfs": [kf.index for kf in col._cur_kfs]}

    gb = system.graph
    meta["n_nodes"] = len(gb.nodes)
    meta["n_edges"] = len(gb.edges)
    meta["n_priors"] = len(gb.priors)
    for k, n_ in enumerate(gb.nodes):
        arrs[f"gn{k}"] = n_
    for k, (i, j, z, w, robust) in enumerate(gb.edges):
        arrs[f"ge{k}_z"] = z
        arrs[f"ge{k}_w"] = w
        arrs[f"ge{k}_ij"] = np.asarray([i, j], np.int64)
        arrs[f"ge{k}_r"] = np.bool_(robust)
    for k, (i, z, w) in enumerate(gb.priors):
        arrs[f"gp{k}_z"] = z
        arrs[f"gp{k}_w"] = w
        arrs[f"gp{k}_i"] = np.int64(i)

    # loop detector database; entries past its storage cap hold None
    ld = system.loop_detector
    meta["n_ld"] = len(ld.poses)
    if ld.poses:
        arrs["ld_poses"] = np.asarray(ld.poses)
        arrs["ld_travel"] = np.asarray(ld.travel)
        stored = np.array([d is not None for d in ld.descs], dtype=bool)
        arrs["ld_stored"] = stored
        if stored.any():
            arrs["ld_sigs"] = np.stack([_np(s) for s in ld.sigs
                                        if s is not None])
            arrs["ld_descs"] = np.stack([_np(d) for d in ld.descs
                                         if d is not None])
    meta["n_loops"] = len(system.loops)
    for k, (i, j, T, fit) in enumerate(system.loops):
        arrs[f"lp{k}_T"] = T
        arrs[f"lp{k}_ijf"] = np.asarray([i, j, fit])

    np.savez_compressed(path, __meta__=json.dumps(meta), **arrs)


def load_slam(path: str, system) -> None:
    """Restore into a freshly constructed SemanticSlam (same config); the
    tensors go to system.device."""
    data = np.load(path, allow_pickle=False)
    meta = json.loads(str(data["__meta__"]))
    dev = system.device

    def t(key):
        return torch.from_numpy(np.array(data[key], copy=True)).to(dev)

    def opt(key):
        return t(key) if key in data else None

    for tag, setter in (("odom", "state"), ("sem", "sem_state")):
        tree = getattr(system, setter)
        n = len(_leaves(tree))
        assert meta[f"n_{tag}"] == n, "config mismatch"
        setattr(system, setter, _rebuild(
            tree, (data[f"{tag}_{i}"] for i in range(n)), dev))

    system.scan_poses = [p for p in data["scan_poses"]]
    system.kf_scan_ids = [int(i) for i in data["kf_scan_ids"]]
    system._scan_idx = int(meta["scan_idx"])
    system._n_loop_factors = int(meta.get("n_loop_factors", 0))
    system._loop_pairs = {tuple(p) for p in meta.get("loop_pairs", [])}
    system.collector.merge_classes = bool(meta.get("merge_classes", False))
    system.fstate = system.fstate._replace(
        last_refined=t("last_refined").float(),
        last_frontend=t("last_frontend").float())
    system._gps_queue = []
    for k in range(meta.get("n_gps", 0)):
        row = data[f"gps{k}"]
        system._gps_queue.append(
            (float(row[0]), row[1:4].copy(), row[4:7].copy()))

    system.keyframes = []
    for k in range(meta["n_kf"]):
        live = f"kf{k}_surf" in data
        system.keyframes.append(sm.Keyframe(
            index=k, pose_init=data[f"kf{k}_pose_init"],
            pose_opt=data[f"kf{k}_pose_opt"],
            clouds=sm.ClassClouds(xyz=t(f"kf{k}_cls"),
                                  mask=t(f"kf{k}_cls_m"),
                                  w=opt(f"kf{k}_cls_w")) if live else None,
            corner_xyz=opt(f"kf{k}_corner"), corner_mask=opt(f"kf{k}_corner_m"),
            surf_xyz=opt(f"kf{k}_surf"), surf_mask=opt(f"kf{k}_surf_m"),
            timestamp=float(data[f"kf{k}_t"]),
            submap_id=int(data[f"kf{k}_sid"])))

    system.collector.submaps = []
    for k in range(meta["n_sm"]):
        s = sm.SubMap(
            index=k, pose_init=data[f"sm{k}_pose_init"],
            pose_opt=data[f"sm{k}_pose_opt"],
            corner_xyz=t(f"sm{k}_corner"), corner_mask=t(f"sm{k}_corner_m"),
            surf_xyz=t(f"sm{k}_surf"), surf_mask=t(f"sm{k}_surf_m"),
            kf_indices=[int(i) for i in data[f"sm{k}_kf_idx"]],
            kf_rel_poses=[T for T in data[f"sm{k}_kf_rel"]],
            class_xyz=opt(f"sm{k}_cls"), class_mask=opt(f"sm{k}_cls_m"),
            class_w=opt(f"sm{k}_cls_w"))
        s.recompute_bbox()
        system.collector.submaps.append(s)
    # derived state, rebuilt lazily from the restored submaps by
    # _drain_gps / _on_submap (release is idempotent)
    system._kf_time_index = []
    system._kf_times_np = None
    system._indexed_submaps = 0
    system._released_submaps = 0
    col, cm = system.collector, meta["col"]
    col.accu_tran = cm["accu_tran"]
    col.accu_rot = cm["accu_rot"]
    col.accu_frame = cm["accu_frame"]
    col._cur_kfs = [system.keyframes[i] for i in cm["open_kfs"]]
    if system.keyframes:
        col._last_pose = system.keyframes[-1].pose_init.copy()

    gb = system.graph
    gb.nodes = [data[f"gn{k}"] for k in range(meta["n_nodes"])]
    gb.edges = []
    for k in range(meta["n_edges"]):
        ij = data[f"ge{k}_ij"]
        robust = bool(data[f"ge{k}_r"]) if f"ge{k}_r" in data else False
        gb.edges.append((int(ij[0]), int(ij[1]), data[f"ge{k}_z"],
                         data[f"ge{k}_w"], robust))
    gb.priors = [(int(data[f"gp{k}_i"]), data[f"gp{k}_z"], data[f"gp{k}_w"])
                 for k in range(meta["n_priors"])]

    ld = system.loop_detector
    ld.descs, ld.sigs, ld.poses, ld.travel = [], [], [], []
    ld._n_stored = 0
    if meta["n_ld"]:
        ld.poses = [p for p in data["ld_poses"]]
        ld.travel = [float(x) for x in data["ld_travel"]]
        if "ld_stored" in data:
            stored = data["ld_stored"]
        else:  # legacy checkpoints: every payload stored
            stored = np.ones(len(ld.poses), bool)
        sigs = iter(data["ld_sigs"]) if stored.any() else iter(())
        descs = iter(data["ld_descs"]) if stored.any() else iter(())

        def dev_next(it):
            return torch.from_numpy(np.array(next(it), copy=True)).to(dev)

        ld.sigs = [dev_next(sigs) if s else None for s in stored]
        ld.descs = [dev_next(descs) if s else None for s in stored]
        ld._n_stored = int(stored.sum())
    system.loops = []
    for k in range(meta["n_loops"]):
        ijf = data[f"lp{k}_ijf"]
        system.loops.append(
            (int(ijf[0]), int(ijf[1]), data[f"lp{k}_T"], float(ijf[2])))
