"""Front-end odometry: the per-scan step (port of
lis_slam_tpu/pipeline/odometry.py; reference src/node/odomEstimationNode.cpp
multi-frame-target mode: updateInitialGuess -> currentCloudInit ->
scan2SubMapOptimization -> transformUpdate -> saveKeyFrames).

`odom_step(state, scan, cfg) -> (state, out)` is plain Python over tensors
on the scan's device: the keyframe insert is a host branch instead of a
`lax.cond`, and the solver loop lives in ops/scan_match.scan_to_map.
`_odom_step_impl` also returns the scan's feature clouds and extracted
cloud, which the full-SLAM step (pipeline/slam.py) reuses.

`odom_step_uniform(state, scan, cfg, allow_kf)` is the cond-free step of
the JAX package (`uniform=True`): the first-frame, external-guess, IMU
attitude and keyframe decisions are per-lane masks, the solver is the
static-schedule scan_match.scan_to_map_scheduled, the keyframe merge runs
masked (`_insert_keyframe_masked`), and every OdomOutput field is a device
tensor: the step never waits on the device. `_odom_step_lanes` runs it over
a leading lane dim, which is batched multi-sequence replay
(parallel/batched.py); odom_step_uniform is its one-lane case.

State layout (fixed capacity, mask-padded), as in the JAX package: the
sliding keyframe ring, the merged morton-ordered corner/surf maps with
per-point keyframe age, and the pose / previous pose / constant-velocity
increment of the initial-guess cascade.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import SlamConfig
from ..ops import features as feat_ops
from ..ops import deskew, pretreatment, projection, scan_match
from ..ops import velocity_deskew, voxel
from ..utils import device as devices, se3


class OdomState(NamedTuple):
    pose: torch.Tensor  # (6,)
    prev_pose: torch.Tensor  # (6,)
    incr: torch.Tensor  # (4, 4) constant-velocity increment
    frame_idx: torch.Tensor  # () int32

    kf_poses: torch.Tensor  # (K, 6)
    kf_count: torch.Tensor  # () int32 total keyframes ever
    kf_head: torch.Tensor  # () int32 ring-buffer slot for next insert
    last_kf_pose: torch.Tensor  # (6,)

    map_corner: torch.Tensor  # (Mc, 3)
    map_corner_age: torch.Tensor  # (Mc,) keyframe index of last observation
    map_corner_mask: torch.Tensor
    map_surf: torch.Tensor  # (Ms, 3)
    map_surf_age: torch.Tensor
    map_surf_mask: torch.Tensor


class OdomOutput(NamedTuple):
    """odom_step's flags and counts are host scalars; the uniform step's
    are device tensors (bool / int32, with the lanes' leading dim)."""

    pose: torch.Tensor  # (6,) optimized pose for this scan
    is_keyframe: bool
    converged: bool
    degenerate: bool
    n_valid: int  # solver correspondences
    iterations: int


def init_state(cfg: SlamConfig, device: torch.device | str = "cuda"
               ) -> OdomState:
    device = devices.resolve(device)
    K = cfg.keyframe.window_size
    mc = cfg.matching.corner_map_capacity
    ms = cfg.matching.surf_map_capacity
    f32 = dict(dtype=torch.float32, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    return OdomState(
        pose=torch.zeros(6, **f32),
        prev_pose=torch.zeros(6, **f32),
        incr=torch.eye(4, **f32),
        frame_idx=torch.zeros((), **i32),
        kf_poses=torch.zeros((K, 6), **f32),
        kf_count=torch.zeros((), **i32),
        kf_head=torch.zeros((), **i32),
        last_kf_pose=torch.zeros(6, **f32),
        map_corner=torch.zeros((mc, 3), **f32),
        map_corner_age=torch.full((mc,), -(10**9), **i32),
        map_corner_mask=torch.zeros(mc, dtype=torch.bool, device=device),
        map_surf=torch.zeros((ms, 3), **f32),
        map_surf_age=torch.full((ms,), -(10**9), **i32),
        map_surf_mask=torch.zeros(ms, dtype=torch.bool, device=device),
    )


class ScanInput(NamedTuple):
    """One padded raw scan on the device, with the fields of the JAX
    ScanInput. The optional tensors default to None and the flags to
    False, which the step reads as the JAX package's neutral zeros: no IMU
    window (no gyro deskew), rotation-only deskew, no external guess, no
    IMU attitude, no ego velocity."""

    points: torch.Tensor  # (P, 4) xyzi
    valid: torch.Tensor  # (P,) bool
    # gyro window for the deskew (lidar frame), padded to M rows
    imu_time: torch.Tensor | None = None  # (M,) absolute seconds
    imu_gyro: torch.Tensor | None = None  # (M, 3)
    imu_valid: torch.Tensor | None = None  # (M,) bool
    scan_start: torch.Tensor | float = 0.0  # () absolute seconds
    imu_accel: torch.Tensor | None = None  # (M, 3)
    # body-frame velocity at scan start for the positional deskew term
    # (findPosition, laserProcessing.cpp:402-425, zeroed by the reference)
    deskew_vel: torch.Tensor | None = None  # (3,)
    # optional external initial guess (IMU preintegration / fusion odometry,
    # updateInitialGuess cascade, odomEstimationNode.cpp:297-419)
    init_guess: torch.Tensor | None = None  # (6,)
    init_guess_valid: bool = False
    # IMU orientation at scan start for roll/pitch slerp fusion
    # (transformUpdate, odomEstimationNode.cpp:976-1006)
    imu_rpy: torch.Tensor | None = None  # (3,)
    imu_rpy_valid: bool = False
    # body velocity + angular rate at scan time for the velocity front end
    # (distortionAdjust.cpp:412-480), cfg.imu.deskew_mode == "velocity"
    vel: torch.Tensor | None = None  # (3,)
    ang_rate: torch.Tensor | None = None  # (3,)
    vel_valid: bool = False
    # Lanes (parallel/batched.py): every tensor gains a leading dim B, the
    # flags become (B,) bool tensors and scan_start a (B,) tensor.


def preprocess(scan: ScanInput, cfg: SlamConfig, return_ext: bool = False):
    """Pretreatment -> deskew -> projection -> extraction -> features.

    The deskew follows cfg.imu: "velocity" mode compensates with the
    scan's ego velocity (dataPretreatNode.cpp:184-253), use_imu rotates by
    the integrated gyro window (laserProcessing IMU path), else none.
    Returns the FeatureClouds, and with `return_ext` also the extracted
    cloud (its `src` column maps grid slots to raw points). A scan with
    lanes (see ScanInput) is preprocessed lane by lane in the same
    launches, and every output gains the lane dim."""
    pre = pretreatment.pretreat(scan.points, scan.valid, cfg.sensor)
    pts = pre.points[..., :3]
    if cfg.imu.deskew_mode == "velocity":
        if isinstance(scan.vel_valid, torch.Tensor):  # per lane, no sync
            pts = velocity_deskew.velocity_deskew(
                pts, pre.rel_time, scan.ang_rate.to(pts), scan.vel.to(pts),
                pre.valid & scan.vel_valid[..., None])
        elif scan.vel_valid:
            pts = velocity_deskew.velocity_deskew(
                pts, pre.rel_time, scan.ang_rate.to(pts), scan.vel.to(pts),
                pre.valid)
    elif cfg.imu.use_imu and scan.imu_time is not None:
        info = deskew.integrate_gyro(scan.imu_time, scan.imu_gyro,
                                     scan.imu_valid, scan.scan_start)
        vel = None if scan.deskew_vel is None else scan.deskew_vel.to(pts)
        pts = deskew.deskew_points(pts, pre.rel_time, info, pre.valid,
                                   vel_body=vel)
    _img, ext = projection.project_and_extract(
        pts, pre.points[..., 3], pre.ring, pre.rel_time, pre.valid,
        cfg.sensor)
    fc = feat_ops.extract_features(ext, cfg.feature,
                                   greedy=cfg.feature.greedy_selection)
    return (fc, ext) if return_ext else fc


def _insert_keyframe(state: OdomState, fc: feat_ops.FeatureClouds,
                     pose: torch.Tensor, cfg: SlamConfig) -> OdomState:
    """Merge the current feature clouds into the sliding-window map (one
    aged-voxel merge per class, see voxel.voxel_merge_aged)."""
    K = cfg.keyframe.window_size
    T = se3.pose_to_matrix(pose)
    kf_count = int(state.kf_count)
    head = int(state.kf_head)
    kf_poses = state.kf_poses.clone()
    kf_poses[head] = pose
    map_c, age_c, mask_c = voxel.voxel_merge_aged(
        se3.transform_points(T, fc.corner_xyz), fc.corner_mask,
        state.map_corner, state.map_corner_age, state.map_corner_mask,
        kf_count, K, cfg.voxel.mapping_corner_leaf,
        cfg.matching.corner_map_capacity, anchor=cfg.voxel.map_anchor)
    map_s, age_s, mask_s = voxel.voxel_merge_aged(
        se3.transform_points(T, fc.surf_xyz), fc.surf_mask,
        state.map_surf, state.map_surf_age, state.map_surf_mask,
        kf_count, K, cfg.voxel.mapping_surf_leaf,
        cfg.matching.surf_map_capacity, anchor=cfg.voxel.map_anchor)
    return state._replace(
        kf_poses=kf_poses,
        kf_count=state.kf_count + 1,
        kf_head=torch.remainder(state.kf_head + 1, K),
        last_kf_pose=pose,
        map_corner=map_c, map_corner_age=age_c, map_corner_mask=mask_c,
        map_surf=map_s, map_surf_age=age_s, map_surf_mask=mask_s,
    )


def _keyframe_gate(pose: torch.Tensor, last_kf_pose: torch.Tensor,
                   kf_count: int, gn: scan_match.GNState,
                   cfg: SlamConfig) -> bool:
    """saveKeyFrames gate (odomEstimationNode.cpp:216-228): the solver must
    have converged this scan, then keyframe on the first frames or on
    per-axis motion of the relative transform since the last keyframe."""
    rel = se3.matrix_to_pose(se3.transform_inverse(
        se3.pose_to_matrix(last_kf_pose)) @ se3.pose_to_matrix(pose))
    yaw, dx, dy = (float(v) for v in rel[2:5].cpu())
    motion = (abs(yaw) >= cfg.keyframe.min_yaw
              or abs(dx) >= cfg.keyframe.min_distance
              or abs(dy) >= cfg.keyframe.min_distance)
    conv = (gn.delta_r < cfg.matching.converge_delta_r_deg
            or gn.delta_t < cfg.matching.converge_delta_t_cm
            or not cfg.keyframe.require_convergence)
    return conv and (kf_count <= cfg.keyframe.bootstrap_frames or motion)


def _matched_clouds(fc: feat_ops.FeatureClouds, cfg: SlamConfig):
    """The clouds scan_to_map matches, by cfg.matching.match_source."""
    m = cfg.matching
    if m.match_source == "full_ds":
        mc_xyz, mc_mask, _ = voxel.voxel_downsample(
            fc.corner_xyz, fc.corner_mask, m.matched_corner_leaf,
            m.matched_corner_capacity)
        ms_xyz, ms_mask, _ = voxel.voxel_downsample(
            fc.surf_xyz, fc.surf_mask, m.matched_surf_leaf,
            m.matched_surf_capacity)
    elif m.match_source == "hybrid":
        # sharp corner subset + voxel-UNIFORM downsample of the FULL surf
        # cloud (spatial coverage, docs/PERF.md "coverage beats count")
        mc_xyz, mc_mask = fc.sharp_corner_xyz, fc.sharp_corner_mask
        ms_xyz, ms_mask, _ = voxel.voxel_downsample(
            fc.surf_xyz, fc.surf_mask, m.matched_surf_leaf,
            m.matched_surf_capacity)
    else:
        mc_xyz, mc_mask = fc.sharp_corner_xyz, fc.sharp_corner_mask
        ms_xyz, ms_mask = fc.sharp_surf_xyz, fc.sharp_surf_mask
    return mc_xyz, mc_mask, ms_xyz, ms_mask


def odom_step(state: OdomState, scan: ScanInput,
              cfg: SlamConfig) -> tuple[OdomState, OdomOutput]:
    """Process one scan end to end: preprocess, initial guess, scan-to-map
    optimization, keyframe insert, velocity model.

    The state may be updated in place, the counterpart of the JAX step's
    donation: thread the returned state, `state, out = odom_step(state,
    scan, cfg)`, and do not reuse the old one (clone it first to step twice
    from one state). The step waits on the device several times per GN
    iteration (the 6x6 solve and the loop control run on the host) and a
    few times per scan for the keyframe bookkeeping."""
    state, out, _fc, _ext = _odom_step_impl(state, scan, cfg)
    return state, out


def _odom_step_impl(state: OdomState, scan: ScanInput, cfg: SlamConfig):
    """odom_step, returning (state, out, feature clouds, extracted
    cloud)."""
    fc, ext = preprocess(scan, cfg, return_ext=True)

    # ---- initial guess cascade (updateInitialGuess :297-419):
    # external guess > constant velocity > hold ----
    T_prev = se3.pose_to_matrix(state.pose)
    guess = se3.matrix_to_pose(T_prev @ state.incr)
    if scan.init_guess_valid:
        guess = scan.init_guess.to(guess)
    kf_count = int(state.kf_count)
    first = kf_count == 0
    if first:
        # first frame: IMU roll/pitch if available (reference seeds attitude)
        guess = state.pose
        if scan.imu_rpy_valid:
            guess = torch.cat([scan.imu_rpy[:2].to(guess), state.pose[2:]])

    # ---- scan-to-map optimization (:596-626) ----
    gn = scan_match.scan_to_map(
        guess, *_matched_clouds(fc, cfg),
        state.map_corner, state.map_corner_mask,
        state.map_surf, state.map_surf_mask,
        cfg.matching, cfg.matching.max_iterations_frontend)
    pose = guess if first else gn.pose

    # IMU roll/pitch slerp fusion (transformUpdate :979-1001)
    if scan.imu_rpy_valid and abs(float(scan.imu_rpy[1])) < 1.4:
        imu_rpy = scan.imu_rpy.to(pose)
        ax = torch.eye(3, dtype=pose.dtype, device=pose.device)
        q_roll = se3.quat_slerp(se3.euler_to_quat(ax[0] * pose[0]),
                                se3.euler_to_quat(ax[0] * imu_rpy[0]),
                                cfg.imu.rpy_weight)
        q_pitch = se3.quat_slerp(se3.euler_to_quat(ax[1] * pose[1]),
                                 se3.euler_to_quat(ax[1] * imu_rpy[1]),
                                 cfg.imu.rpy_weight)
        pose = torch.cat([se3.quat_to_euler(q_roll)[:1],
                          se3.quat_to_euler(q_pitch)[1:2], pose[2:]])

    # constraintTransformation clamps (transformUpdate :976-1006)
    rt, zt = cfg.runtime.rotation_tolerance, cfg.runtime.z_tolerance
    pose = torch.cat([se3.constrain_angle(pose[:2], rt), pose[2:5],
                      se3.constrain_angle(pose[5:], zt)])

    # ---- keyframe insert + map update (saveKeyFrames) ----
    is_kf = _keyframe_gate(pose, state.last_kf_pose, kf_count, gn, cfg)
    if is_kf:
        state = _insert_keyframe(state, fc, pose, cfg)

    # ---- velocity model update ----
    T_new = se3.pose_to_matrix(pose)
    incr = (torch.eye(4, dtype=pose.dtype, device=pose.device) if first
            else se3.transform_inverse(T_prev) @ T_new)
    state = state._replace(pose=pose, prev_pose=state.pose, incr=incr,
                           frame_idx=state.frame_idx + 1)
    out = OdomOutput(pose=pose, is_keyframe=is_kf, converged=gn.converged,
                     degenerate=gn.degenerate, n_valid=gn.n_valid,
                     iterations=gn.it)
    return state, out, fc, ext


# ---------------------------------------------------------------------------
# the cond-free (uniform) step, over lanes
# ---------------------------------------------------------------------------


def _lane_flag(flag, b: int, device: torch.device) -> torch.Tensor:
    """A ScanInput flag as a (b,) bool tensor on `device`: a host bool is
    filled in (no copy), a tensor is taken as the lanes' flags."""
    if isinstance(flag, torch.Tensor):
        return flag.reshape(b).to(torch.bool)
    return torch.full((b,), bool(flag), dtype=torch.bool, device=device)


def _keyframe_gate_device(pose: torch.Tensor, last_kf_pose: torch.Tensor,
                          kf_count: torch.Tensor, gn: scan_match.GNState,
                          cfg: SlamConfig) -> torch.Tensor:
    """_keyframe_gate over lanes, as a (B,) bool tensor on the device
    (JAX `_keyframe_gate`): converged this scan, then the first frames or
    per-axis motion since the last keyframe."""
    rel = se3.matrix_to_pose(se3.matmul_lanes(
        se3.transform_inverse_lanes(se3.pose_to_matrix(last_kf_pose)),
        se3.pose_to_matrix(pose)))
    kc = cfg.keyframe
    motion = ((torch.abs(rel[:, 2]) >= kc.min_yaw)
              | (torch.abs(rel[:, 3]) >= kc.min_distance)
              | (torch.abs(rel[:, 4]) >= kc.min_distance))
    conv = ((gn.delta_r < cfg.matching.converge_delta_r_deg)
            | (gn.delta_t < cfg.matching.converge_delta_t_cm))
    if not kc.require_convergence:
        conv = torch.ones_like(conv)
    return conv & ((kf_count <= kc.bootstrap_frames) | motion)


def _insert_keyframe_masked(state: OdomState, fc: feat_ops.FeatureClouds,
                            pose: torch.Tensor, is_kf: torch.Tensor,
                            cfg: SlamConfig) -> OdomState:
    """Cond-free keyframe insert over lanes (JAX `_insert_keyframe_masked`):
    the aged-voxel merge always runs, with a lane's new clouds masked out
    where is_kf (B,) is False, and the ring bookkeeping (kf_poses,
    kf_count, kf_head, last_kf_pose) advances only where it is True. A
    masked merge leaves the map's content as it was (its expired voxels
    drop as the conditional insert would drop them at the next keyframe)."""
    K = cfg.keyframe.window_size
    T = se3.pose_to_matrix(pose)
    kf = is_kf[:, None]
    merged = [voxel.voxel_merge_aged(
        se3.transform_points_lanes(T, xyz), mask & kf, pts, age, mmask,
        state.kf_count, K, leaf, cap, anchor=cfg.voxel.map_anchor)
        for xyz, mask, pts, age, mmask, leaf, cap in (
            (fc.corner_xyz, fc.corner_mask, state.map_corner,
             state.map_corner_age, state.map_corner_mask,
             cfg.voxel.mapping_corner_leaf, cfg.matching.corner_map_capacity),
            (fc.surf_xyz, fc.surf_mask, state.map_surf, state.map_surf_age,
             state.map_surf_mask, cfg.voxel.mapping_surf_leaf,
             cfg.matching.surf_map_capacity))]
    (map_c, age_c, mask_c), (map_s, age_s, mask_s) = merged
    slot = (torch.arange(K, device=pose.device) == state.kf_head[:, None]) & kf
    return state._replace(
        kf_poses=torch.where(slot[..., None], pose[:, None, :],
                             state.kf_poses),
        kf_count=state.kf_count + is_kf.to(torch.int32),
        kf_head=torch.where(is_kf, torch.remainder(state.kf_head + 1, K),
                            state.kf_head),
        last_kf_pose=torch.where(kf, pose, state.last_kf_pose),
        map_corner=map_c, map_corner_age=age_c, map_corner_mask=mask_c,
        map_surf=map_s, map_surf_age=age_s, map_surf_mask=mask_s)


def _odom_step_lanes(state: OdomState, scan: ScanInput, cfg: SlamConfig,
                     allow_kf: bool = True):
    """The uniform step over lanes: state and scan with a leading dim B.
    Returns (state, out, feature clouds, extracted cloud), all lanes.

    allow_kf=False runs the step WITHOUT the keyframe merge (the batched
    replay's host cadence, RuntimeConfig.batched_kf_every): the gate is not
    consumed, last_kf_pose stays, and the keyframe fires at the next step
    that allows it."""
    b, dev = state.pose.shape[0], state.pose.device
    fc, ext = preprocess(scan, cfg, return_ext=True)

    # ---- initial guess cascade: external guess > constant velocity >
    # hold; IMU roll/pitch on the first frame ----
    T_prev = se3.pose_to_matrix(state.pose)
    guess = se3.matrix_to_pose(se3.matmul_lanes(T_prev, state.incr))
    if scan.init_guess is not None:
        guess = torch.where(
            _lane_flag(scan.init_guess_valid, b, dev)[:, None],
            scan.init_guess.to(guess), guess)
    first = state.kf_count == 0
    first_guess = state.pose
    rpy_ok = _lane_flag(scan.imu_rpy_valid, b, dev)
    if scan.imu_rpy is not None:
        imu_rpy = scan.imu_rpy.to(guess)
        first_guess = torch.where(
            rpy_ok[:, None], torch.cat([imu_rpy[:, :2], state.pose[:, 2:]],
                                       dim=1), state.pose)
    guess = torch.where(first[:, None], first_guess, guess)

    # ---- scan-to-map optimization, static schedule ----
    m = cfg.matching
    gn = scan_match.scan_to_map_scheduled(
        guess, *_matched_clouds(fc, cfg),
        state.map_corner, state.map_corner_mask,
        state.map_surf, state.map_surf_mask,
        m, m.uniform_iters, m.uniform_refresh)
    pose = torch.where(first[:, None], guess, gn.pose)

    # IMU roll/pitch slerp fusion (transformUpdate :979-1001)
    if scan.imu_rpy is not None:
        do_slerp = rpy_ok & (torch.abs(imu_rpy[:, 1]) < 1.4)
        ax = torch.eye(3, dtype=pose.dtype, device=dev)
        q_roll = se3.quat_slerp(se3.euler_to_quat(ax[0] * pose[:, :1]),
                                se3.euler_to_quat(ax[0] * imu_rpy[:, :1]),
                                cfg.imu.rpy_weight)
        q_pitch = se3.quat_slerp(se3.euler_to_quat(ax[1] * pose[:, 1:2]),
                                 se3.euler_to_quat(ax[1] * imu_rpy[:, 1:2]),
                                 cfg.imu.rpy_weight)
        fused = torch.stack([se3.quat_to_euler(q_roll)[:, 0],
                             se3.quat_to_euler(q_pitch)[:, 1]], dim=1)
        pose = torch.cat([torch.where(do_slerp[:, None], fused, pose[:, :2]),
                          pose[:, 2:]], dim=1)

    # constraintTransformation clamps (transformUpdate :976-1006)
    rt, zt = cfg.runtime.rotation_tolerance, cfg.runtime.z_tolerance
    pose = torch.cat([se3.constrain_angle(pose[:, :2], rt), pose[:, 2:5],
                      se3.constrain_angle(pose[:, 5:], zt)], dim=1)

    # ---- keyframe insert, masked per lane ----
    is_kf = _keyframe_gate_device(pose, state.last_kf_pose, state.kf_count,
                                  gn, cfg)
    if allow_kf:
        state = _insert_keyframe_masked(state, fc, pose, is_kf, cfg)
    else:
        is_kf = torch.zeros_like(is_kf)

    # ---- velocity model update ----
    eye = torch.eye(4, dtype=pose.dtype, device=dev)
    incr = torch.where(first[:, None, None], eye, se3.matmul_lanes(
        se3.transform_inverse_lanes(T_prev), se3.pose_to_matrix(pose)))
    state = state._replace(pose=pose, prev_pose=state.pose, incr=incr,
                           frame_idx=state.frame_idx + 1)
    out = OdomOutput(pose=pose, is_keyframe=is_kf, converged=gn.converged,
                     degenerate=gn.degenerate, n_valid=gn.n_valid,
                     iterations=gn.it)
    return state, out, fc, ext


def odom_step_uniform(state: OdomState, scan: ScanInput, cfg: SlamConfig,
                      allow_kf: bool = True) -> tuple[OdomState, OdomOutput]:
    """The cond-free per-scan step of one sequence (JAX
    `odom_step_uniform`): the one-lane case of _odom_step_lanes. Every
    OdomOutput field is a device tensor; nothing waits on the device.
    allow_kf=False leaves the keyframe merge out (see _odom_step_lanes)."""
    lanes = ScanInput(*(t[None] if isinstance(t, torch.Tensor) else t
                        for t in scan))
    st, out, _fc, _ext = _odom_step_lanes(
        OdomState(*(t[None] for t in state)), lanes, cfg, allow_kf)
    return (OdomState(*(t[0] for t in st)),
            OdomOutput(*(t[0] for t in out)))
