#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (lis_slam_torch) on one NVIDIA GPU.

Drives the port's front-end odometry step, its LiDAR-inertial path and
the full SLAM system, with both hand-written CUDA kernels, through these
phases (one or more lines each):

  1. device - torch and CUDA versions, the card's name and power limit;
  2. build  - nvcc builds csrc/knn.cu (K1, exact kNN) and csrc/gn.cu (K2,
              fused Gauss-Newton accumulation) from the checkout;
  3. K1     - kernel against its plain PyTorch version at the front end's
              shapes, on a morton-ordered map built by voxel_merge_aged;
  4. K2     - kernel against its plain version, both modes, on K1's
              candidates;
  5. main   - the synthetic HDL-64 circuit (make_world(seed=5), radius 60 m,
              8 m/s, 60 scans, rendered on the card) through
              pipeline.driver.replay_odometry -> odometry.odom_step, once
              with gn_backend="xla" (K1 + plain GN) and once with "pallas"
              (K1 + K2); then each scan stepped from the same state under
              both backends, and the host syncs per scan;
  6. lio    - the lio preset (VLP-16 + IMU, 16 x 1800, gn_backend "pallas")
              on 60 motion-distorted sweeps of the same world and circuit
              rendered on the card, 24 IMU samples per window: LioOdometry
              (gyro + positional deskew, IMU guess, bias refresh), the
              velocity front end, no deskew as a contrast,
              predict_imu_rate, the IMU chain's time on the host and on the
              card, and K1/K2 against their plain versions at the path's
              shapes on the LIO map;
  7. greedy - the first 10 scans of the main circuit with the
              reference-faithful greedy feature selection, against the
              vectorized selection's run;
  8. slam   - the full SLAM system (pipeline/slam.py SemanticSlam: front
              end, semantic refinement, submaps, EPSC loop closure, ICP
              verification, pose graph) on the JAX bench's plaza lap
              (bench.py:123-258): 100 HDL-64 scans of the exactly periodic
              10 m circle plus 40 past the closure on a second noise
              render, rendered on the card, ground-truth labels, the
              bench's yaw drift injected through pose_hook, default
              SlamConfig with gn_backend "pallas"; the same run again,
              untimed, with its host syncs counted by stage; then K1 and
              K2 at the back end's shapes against their plain versions,
              and the pose-graph LM on the card and on the host.

Then one JSON line with each kernel's launches (in all, and per path),
error against its plain version and times, and last the device JSON line.
Any failed phase exits nonzero with no result line; so does a machine
without a CUDA device, and a directory without the lis_slam_torch package.

    python3 chip_smoke.py [--scans 60] [--out smoke_out]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback
import warnings

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
K1_SOURCE = "lis_slam_torch/csrc/knn.cu"
K2_SOURCE = "lis_slam_torch/csrc/gn.cu"
K1_REPLACES = "lis_slam_tpu/ops/pallas_knn.py:46"
K2_REPLACES = "lis_slam_tpu/ops/pallas_gn.py:62"
KNN_RTOL = 1e-5  # distances: same float32 ops in the same order both sides
GN_ATOL = 2e-4  # H, g scaled by their max, as tests/test_pallas_gn.py
ATE_MAX = 0.1  # m, per run
RPE_T_MAX = 0.1  # m, per run
BACKEND_AGREE_M = 0.02  # per-scan position, xla vs pallas, same state
LIO_SCANS = 60
VLP16 = np.linspace(15.0, -15.0, 16)  # the fan of tests/test_lio.py
# ATE bars of the lio phase's sequence: the JAX package on a CPU
# (scripts/lio_accuracy_bars.py, numpy renderer, gn_backend "xla"). The
# card's renderer draws other noise over the same geometry, so a run may
# reach 1.5 x its bar + 0.02 m; "none" is printed as a contrast only.
JAX_ATE = {"lio": 0.7513362695843023, "velocity": 0.3204856384483959,
           "none": 0.3534227909847982}
GREEDY_SCANS = 10
GREEDY_GAP_M = 0.1  # per-scan position vs the vectorized selection
SLAM_LAP = 100  # scans per plaza lap (bench.py:133)
SLAM_EXTRA = 40  # scans past the closure, second noise render (:199)
SLAM_WARMUP = 10
# the JAX package's corrected ATE on the slam phase's sequence, on a CPU
# (scripts/full_slam_accuracy_bars.py: numpy renderer, gn_backend "xla",
# aligned ATE; raw 0.1521 m, 10 submaps, 6 loop factors, 47 keyframes).
# The card's renderer draws other noise over the same geometry: a run may
# reach 1.5 x this + 0.02 m.
JAX_SLAM_ATE = 0.027203119709521835


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() over `iters` launches, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this smoke run needs a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    log("device", f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"devices {torch.cuda.device_count()} "
        f"name {torch.cuda.get_device_name(0)}")
    print(card, flush=True)  # name, power limit exactly as nvidia-smi says
    return card


def phase_build(out_dir: str) -> None:
    from lis_slam_torch.ops import cuda_build, gn_cuda, knn_cuda

    for name, lib_fn, flags in (("knn", knn_cuda._lib, knn_cuda._FLAGS),
                                ("gn", gn_cuda._lib, gn_cuda._FLAGS)):
        t = time.perf_counter()
        lib_fn()
        dt = time.perf_counter() - t
        report = cuda_build.build_log(name, flags)
        with open(os.path.join(out_dir, f"build_{name}.log"), "w") as f:
            f.write(report)
        usage = [ln.strip() for ln in report.splitlines()
                 if "registers" in ln or "spill" in ln]
        log("build", f"{name}.cu built in {dt:.2f} s; ptxas: "
            + " | ".join(usage))


def _build_inputs(scans, gt, cfg, dev):
    """A real slice state: the maps after 5 keyframes of the circuit, and
    the matched clouds of scan 5 with its ground-truth guess."""
    import torch
    from lis_slam_torch.ops import voxel
    from lis_slam_torch.pipeline import odometry, trajectory
    from lis_slam_torch.utils import se3

    gt_rel = trajectory.relative_to_first(gt[:6])
    mc = torch.zeros((cfg.matching.corner_map_capacity, 3), device=dev)
    ms = torch.zeros((cfg.matching.surf_map_capacity, 3), device=dev)
    mc_age = torch.full((mc.shape[0],), -(10**9), dtype=torch.int32,
                        device=dev)
    ms_age = torch.full((ms.shape[0],), -(10**9), dtype=torch.int32,
                        device=dev)
    mc_mask = torch.zeros(mc.shape[0], dtype=torch.bool, device=dev)
    ms_mask = torch.zeros(ms.shape[0], dtype=torch.bool, device=dev)
    for i in range(5):
        fc = odometry.preprocess(scans[i], cfg)
        T = se3.pose_to_matrix(torch.as_tensor(gt_rel[i], dtype=torch.float32,
                                               device=dev))
        mc, mc_age, mc_mask = voxel.voxel_merge_aged(
            se3.transform_points(T, fc.corner_xyz), fc.corner_mask, mc,
            mc_age, mc_mask, i, cfg.keyframe.window_size,
            cfg.voxel.mapping_corner_leaf, cfg.matching.corner_map_capacity)
        ms, ms_age, ms_mask = voxel.voxel_merge_aged(
            se3.transform_points(T, fc.surf_xyz), fc.surf_mask, ms, ms_age,
            ms_mask, i, cfg.keyframe.window_size, cfg.voxel.mapping_surf_leaf,
            cfg.matching.surf_map_capacity)
    fc = odometry.preprocess(scans[5], cfg)
    qc, qc_mask, qs, qs_mask = odometry._matched_clouds(fc, cfg)
    pose = torch.as_tensor(gt_rel[5], dtype=torch.float32, device=dev)
    return dict(corner=(qc, qc_mask, mc, mc_mask),
                surf=(qs, qs_mask, ms, ms_mask), pose=pose)


def _check_knn(tag, name, q, ref, mask, k, cap):
    """K1 against its plain version on one case: distances equal (rtol
    KNN_RTOL), the same unfilled slots, indices equal off exact ties, the
    gathered xyz equal to ref[idx]. Returns (max |d - d_plain|, kernel ms,
    plain ms)."""
    import torch
    from lis_slam_torch.ops import knn_cuda

    d, i, xyz = knn_cuda.knn(q, ref, mask, k=k, max_sq_dist=cap)
    dp, ip, _xp = knn_cuda.knn_plain(q, ref, mask, k=k, max_sq_dist=cap)
    torch.cuda.synchronize()
    check(bool(torch.equal(torch.isinf(d), torch.isinf(dp))),
          f"{tag} {name}: filled slots differ")
    check(bool(torch.equal(i < 0, torch.isinf(d))),
          f"{tag} {name}: index -1 and d=inf disagree")
    fin = torch.isfinite(dp)
    err = float(torch.max(torch.abs(d[fin] - dp[fin]))) if fin.any() else 0.0
    rel = torch.abs(d[fin] - dp[fin]) <= KNN_RTOL * torch.abs(dp[fin])
    check(bool(rel.all()), f"{tag} {name}: distances differ (max {err})")
    # indices equal except between exactly tied distances
    diff = i != ip
    check(bool(torch.equal(d[diff], dp[diff])),
          f"{tag} {name}: {int(diff.sum())} indices differ off ties")
    near = ref[torch.clamp(i, min=0).long()]
    check(bool(torch.equal(torch.where((i >= 0)[..., None], near, 0.0), xyz)),
          f"{tag} {name}: xyz != ref[idx]")
    ms_k = cuda_ms(lambda: knn_cuda.knn(q, ref, mask, k=k, max_sq_dist=cap))
    ms_p = cuda_ms(lambda: knn_cuda.knn_plain(q, ref, mask, k=k,
                                              max_sq_dist=cap), iters=5)
    filled = float((i >= 0).float().mean())
    log(tag, f"{name}: ok, max|d-d_plain| {err:.3g}, index ties "
        f"{int(diff.sum())}, filled {filled:.3f}, kernel {ms_k:.4f} ms, "
        f"plain {ms_p:.4f} ms")
    return err, ms_k, ms_p


def phase_k1(inp, dev):
    import torch
    from lis_slam_torch.utils import se3

    T = se3.pose_to_matrix(inp["pose"])
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    qc, _, mc, mc_mask = inp["corner"]
    qs, _, ms, ms_mask = inp["surf"]
    cw = se3.transform_points(T, qc).contiguous()
    sw = se3.transform_points(T, qs).contiguous()
    holes = ms_mask & (torch.rand(ms_mask.shape, generator=gen,
                                  device=dev) > 0.1)
    cases = [
        # name, query, map, mask, k, cap
        ("corner Q1024 N16384 k8 cap4", cw, mc, mc_mask, 8, 4.0),
        ("surf Q2048 N65536 k8 cap4", sw, ms, ms_mask, 8, 4.0),
        ("surf Q2000 N65536 k1 nocap holes", sw[:2000].contiguous(), ms,
         holes, 1, None),
        ("corner Q1000 N16384 k8 nocap", cw[:1000].contiguous(), mc, mc_mask,
         8, None),
    ]
    worst = 0.0
    timing = None
    for name, q, ref, mask, k, cap in cases:
        err, ms_k, ms_p = _check_knn("K1", name, q, ref, mask, k, cap)
        worst = max(worst, err)
        if timing is None or q.shape[0] * ref.shape[0] > timing[0]:
            timing = (q.shape[0] * ref.shape[0], ms_k, ms_p)
    return {"max_abs_err": worst, "ms": timing[1], "plain_ms": timing[2]}


def _scaled_err(H, g, Hr, gr):
    """max|H - Hr| / max|Hr| and the same for g (tests/test_pallas_gn.py)."""
    import torch

    eh = float(torch.max(torch.abs(H - Hr))) / (float(torch.max(
        torch.abs(Hr))) + 1e-9)
    eg = float(torch.max(torch.abs(g - gr))) / (float(torch.max(
        torch.abs(gr))) + 1e-9)
    return eh, eg


def _gn_world(mode, n_map, dev, seed):
    """The well-conditioned worlds of tests/test_pallas_gn.py, dense enough
    to fill a slice-sized map: vertical poles (corner) or a ground plane
    and two walls (surf), as an (n_map, 3) buffer + mask."""
    import torch

    rng = np.random.default_rng(seed)
    if mode == "corner":
        pts = []
        for _ in range(n_map // 40):
            x, y = rng.uniform(-40, 40, 2)
            z = np.linspace(0, 4, 32)
            pts.append(np.stack([np.full(32, x), np.full(32, y), z], 1))
        pts = np.concatenate(pts) + rng.normal(0, 0.01, (len(pts) * 32, 3))
    else:
        n = n_map // 3
        g = np.stack([rng.uniform(-40, 40, n), rng.uniform(-40, 40, n),
                      np.zeros(n)], 1)
        w1 = np.stack([rng.uniform(-40, 40, n // 2), np.full(n // 2, 10.0),
                       rng.uniform(0, 6, n // 2)], 1)
        w2 = np.stack([np.full(n // 2, -12.0), rng.uniform(-40, 40, n // 2),
                       rng.uniform(0, 6, n // 2)], 1)
        pts = np.concatenate([g, w1, w2])
        pts = pts + rng.normal(0, 0.005, pts.shape)
    buf = np.zeros((n_map, 3), np.float32)
    buf[:len(pts)] = pts
    mask = np.arange(n_map) < len(pts)
    return (torch.from_numpy(buf).to(dev), torch.from_numpy(mask).to(dev),
            pts.astype(np.float32), rng)


def phase_k2(inp, cfg, dev):
    """Strict check (scaled atol GN_ATOL) on the well-conditioned worlds at
    the slice's shapes; then the circuit's real clouds, where float32
    rounding alone moves the plain version's surf H (see below)."""
    import torch
    from lis_slam_torch.ops import gn_cuda, knn_cuda, voxel
    from lis_slam_torch.utils import se3

    k = cfg.matching.nn_cache_k
    worst = 0.0
    timing = None
    pose_true = torch.tensor([0.01, -0.02, 0.08, 0.5, -0.3, 0.05],
                             device=dev)
    for mode, n_map, n_q, seed in (("corner", 16384, 1024, 3),
                                   ("surf", 65536, 2048, 4)):
        buf, buf_mask, world, rng = _gn_world(mode, n_map, dev, seed)
        leaf = (cfg.voxel.mapping_corner_leaf if mode == "corner"
                else cfg.voxel.mapping_surf_leaf)
        ref, _, ref_mask = voxel.voxel_merge_aged(  # morton-ordered map
            buf, buf_mask, torch.zeros_like(buf),
            torch.zeros(n_map, dtype=torch.int32, device=dev),
            torch.zeros_like(buf_mask), 0, 1, leaf, n_map)
        sel = world[rng.integers(0, len(world), n_q)]
        sel = sel + rng.normal(0, 0.02, sel.shape).astype(np.float32)
        T_inv = se3.transform_inverse(se3.pose_to_matrix(pose_true))
        q = se3.transform_points(T_inv, torch.from_numpy(sel).to(dev))
        q_mask = torch.from_numpy(rng.uniform(size=n_q) > 0.1).to(dev)
        w = torch.from_numpy(rng.uniform(0.5, 1.5, n_q).astype(
            np.float32)).to(dev)
        pose = pose_true + torch.tensor([0.002, -0.001, 0.004, 0.05, -0.03,
                                         0.01], device=dev)
        T = se3.pose_to_matrix(pose)
        d, _, cand = knn_cuda.knn(se3.transform_points(T, q).contiguous(),
                                  ref, ref_mask, k=k, max_sq_dist=4.0)
        ok = (d < 4.0).contiguous()
        sc = gn_cuda.pack_scalars(pose, cfg.matching, mode).contiguous()
        args = (q.contiguous(), q_mask, cand, ok, w, sc, mode, k)
        H, g, nv = gn_cuda.gn_partials(*args)
        Hp, gp, nvp = gn_cuda.gn_partials_plain(*args)
        H2, g2, _ = gn_cuda.gn_partials(*args)
        torch.cuda.synchronize()
        check(bool(torch.equal(H, H2) and torch.equal(g, g2)),
              f"K2 {mode}: H or g not reproducible run to run")
        nv, nvp = int(nv), int(nvp)
        check(nvp > n_q // 4, f"K2 {mode}: only {nvp} valid rows")
        check(nv == nvp, f"K2 {mode}: n_valid {nv} vs plain {nvp}")
        eh, eg = _scaled_err(H, g, Hp, gp)
        check(eh <= GN_ATOL and eg <= GN_ATOL,
              f"K2 {mode}: scaled error H {eh:.3g} g {eg:.3g}")
        ms_k = cuda_ms(lambda: gn_cuda.gn_partials(*args))
        ms_p = cuda_ms(lambda: gn_cuda.gn_partials_plain(*args), iters=5)
        log("K2", f"{mode} Q{n_q} N{n_map} k{k}: ok, n_valid {nv} (plain "
            f"{nvp}), scaled err H {eh:.3g} g {eg:.3g}, kernel "
            f"{ms_k:.4f} ms, plain {ms_p:.4f} ms")
        worst = max(worst, eh, eg)
        if timing is None or n_q > timing[0]:
            timing = (n_q, ms_k, ms_p)

    # The circuit's own clouds. Some surf rows have five nearly collinear
    # neighbours (ring lines in sparse areas): their plane normal is
    # ill-defined, so the plain version in float32 and in float64 already
    # differ by ~1e-2 scaled. The kernel must stay within that rounding
    # noise: its distance to the float64 plain version may not exceed
    # twice the float32 plain version's.
    _check_gn_real("K2", "circuit", inp, cfg)
    return {"max_abs_err": worst, "ms": timing[1], "plain_ms": timing[2]}


def _check_gn_real(tag, label, inp, cfg):
    """K2 on a path's real matched clouds against its map, near the true
    pose: no further from the float64 plain version than twice the float32
    plain version (or GN_ATOL scaled)."""
    import torch
    from lis_slam_torch.ops import gn_cuda, knn_cuda
    from lis_slam_torch.utils import se3

    k = cfg.matching.nn_cache_k
    dev = inp["pose"].device
    pose = inp["pose"] + torch.tensor([0.002, -0.001, 0.004, 0.05, -0.03,
                                       0.01], device=dev)
    T = se3.pose_to_matrix(pose)
    for mode in ("corner", "surf"):
        q, q_mask, ref, ref_mask = inp[mode]
        d, _, cand = knn_cuda.knn(se3.transform_points(T, q).contiguous(),
                                  ref, ref_mask, k=k, max_sq_dist=4.0)
        ok = (d < 4.0).contiguous()
        w = torch.ones(q.shape[0], device=dev)
        sc = gn_cuda.pack_scalars(pose, cfg.matching, mode).contiguous()
        args = (q.contiguous(), q_mask.contiguous(), cand, ok, w, sc)
        H, g, nv = gn_cuda.gn_partials(*args, mode, k)
        Hp, gp, nvp = gn_cuda.gn_partials_plain(*args, mode, k)
        Hd, gd, nvd = gn_cuda.gn_partials_plain(
            *(a.double() if a.is_floating_point() else a for a in args),
            mode, k)
        check(int(nvp) > 0, f"{tag} {label} {mode}: no valid rows")
        e_k = max(_scaled_err(H.double(), g.double(), Hd, gd))
        e_p = max(_scaled_err(Hp.double(), gp.double(), Hd, gd))
        e_kp = max(_scaled_err(H, g, Hp, gp))
        log(tag, f"{label} {mode} Q{q.shape[0]} N{ref.shape[0]}: n_valid "
            f"{int(nv)} (plain f32 {int(nvp)}, f64 {int(nvd)}), scaled err "
            f"vs plain f32 {e_kp:.3g}; vs plain f64: kernel {e_k:.3g}, "
            f"plain f32 {e_p:.3g}")
        check(e_k <= max(GN_ATOL, 2.0 * e_p),
              f"{tag} {label} {mode}: kernel {e_k:.3g} off the f64 plain "
              f"version, plain f32 {e_p:.3g}")


def phase_main(scans, gt, cfg, dev, out_dir):
    import dataclasses

    import torch
    from lis_slam_torch.pipeline import driver, odometry, trajectory

    n = len(scans)
    gt_rel = trajectory.relative_to_first(gt[:n])
    runs, counts = {}, {}
    torch.cuda.reset_peak_memory_stats()
    for backend in ("xla", "pallas"):
        c = cfg.replace(matching=dataclasses.replace(cfg.matching,
                                                     gn_backend=backend))
        _zero_launches()
        res = driver.replay_odometry(scans, c, warmup=5, device=dev)
        counts[backend] = _launches()
        ate = trajectory.ate_rmse(res.poses, gt_rel, align=False)
        rpe_t, rpe_r = trajectory.rpe(res.poses, gt_rel)
        check(np.all(np.isfinite(res.poses)) and res.poses.shape == (n, 6),
              f"main {backend}: poses not finite (n, 6)")
        log("main", f"gn_backend={backend}: {res.scans_per_sec:.3f} scans/s "
            f"({n - 5} timed scans, {res.wall_s:.3f} s), ATE {ate:.4f} m, "
            f"RPE-t {rpe_t:.4f} m, RPE-r {rpe_r:.4f} deg, GN iterations "
            f"mean {res.iterations.mean():.2f}, keyframes "
            f"{int(res.keyframes.sum())}, K1 launches {counts[backend][0]}, "
            f"K2 launches {counts[backend][1]}")
        check(ate < ATE_MAX, f"main {backend}: ATE {ate} >= {ATE_MAX}")
        check(rpe_t < RPE_T_MAX, f"main {backend}: RPE-t {rpe_t}")
        runs[backend] = res
    log("main", "peak device memory over both runs "
        f"{torch.cuda.max_memory_allocated()} bytes")
    check(counts["xla"][0] > 0 and counts["pallas"][0] > 0,
          "K1 was not launched on the main path")
    check(counts["xla"][1] == 0 and counts["pallas"][1] > 0,
          "K2 launches do not follow gn_backend")

    # Backend agreement per scan, from the same state: each scan is stepped
    # from the xla run's state under both backends. The two free-running
    # runs drift further apart: a scan that stops at the iteration cap
    # rather than converging keyframes in one run and not the other, and
    # the first-observation-anchored map keeps the difference.
    free_gap = np.linalg.norm(
        runs["xla"].poses[:, 3:] - runs["pallas"].poses[:, 3:], axis=1)
    cx, cp = (cfg.replace(matching=dataclasses.replace(
        cfg.matching, gn_backend=b)) for b in ("xla", "pallas"))
    state = odometry.init_state(cx, dev)
    step_gap = []
    for s in scans:
        copy = odometry.OdomState(*(t.clone() for t in state))
        _, out_p = odometry.odom_step(copy, s, cp)
        state, out_x = odometry.odom_step(state, s, cx)
        step_gap.append(float(torch.linalg.vector_norm(
            out_x.pose[3:] - out_p.pose[3:])))
    step_gap = np.asarray(step_gap)
    log("main", f"per-scan position gap xla vs pallas from the same state: "
        f"max {step_gap.max():.5f} m, mean {step_gap.mean():.5f} m; "
        f"free-running runs: max {free_gap.max():.5f} m, median "
        f"{np.median(free_gap):.5f} m")
    with open(os.path.join(out_dir, "main_gaps.json"), "w") as f:
        json.dump({"step_gap_m": step_gap.tolist(),
                   "free_gap_m": free_gap.tolist(),
                   "iterations": {b: r.iterations.tolist()
                                  for b, r in runs.items()},
                   "keyframes": {b: r.keyframes.astype(int).tolist()
                                 for b, r in runs.items()}}, f)
    check(step_gap.max() < BACKEND_AGREE_M,
          f"backends disagree by {step_gap.max()} m from the same state")

    # host syncs per scan: every synchronizing CUDA call warns once
    for c in (cx, cp):
        state = odometry.init_state(c, dev)
        for s in scans[:5]:
            state, _ = odometry.odom_step(state, s, c)
        iters = 0
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                for s in scans[5:15]:
                    state, out = odometry.odom_step(state, s, c)
                    iters += out.iterations
            finally:
                torch.cuda.set_sync_debug_mode("default")
        syncs = sum("synchronizing" in str(w.message) for w in caught)
        log("main", f"gn_backend={c.matching.gn_backend}: {syncs / 10:.1f} "
            f"host syncs per scan at {iters / 10:.1f} GN iterations per scan "
            f"(scans 5-14)")
    return ({"main_xla": counts["xla"], "main_pallas": counts["pallas"]},
            runs["pallas"].poses)


def _launches():
    from lis_slam_torch.ops import gn_cuda, knn_cuda

    return knn_cuda.knn.launches, gn_cuda.gn_partials.launches


def _zero_launches():
    from lis_slam_torch.ops import gn_cuda, knn_cuda

    knn_cuda.knn.launches = 0
    gn_cuda.gn_partials.launches = 0


def _accuracy(tag, poses, gt):
    from lis_slam_torch.pipeline import trajectory

    n = len(poses)
    check(np.all(np.isfinite(poses)) and poses.shape == (n, 6),
          f"{tag}: poses not finite (n, 6)")
    gt_rel = trajectory.relative_to_first(gt[:n])
    rpe_t, rpe_r = trajectory.rpe(poses, gt_rel)
    return trajectory.ate_rmse(poses, gt_rel, align=False), rpe_t, rpe_r


def _imu_chain_ms(system, window, cfg, device, dtype, reps=20):
    """Host-clock ms of one scan's IMU chain (lio._lio_prestep, then
    lio._lio_poststep2) from the run's final state, with every tensor
    moved to `device` and `dtype`: the same functions the run calls."""
    import torch
    from lis_slam_torch.pipeline import driver, lio

    def mv(x):
        if isinstance(x, torch.Tensor):
            return x.to(device, dtype if x.is_floating_point() else x.dtype)
        if isinstance(x, tuple):
            vals = [mv(v) for v in x]
            return type(x)(*vals) if hasattr(x, "_fields") else tuple(vals)
        return x

    _it, ig, ia, _iv = driver.pad_imu_window(cfg, *window[1:4])
    ig, ia = mv(torch.from_numpy(ig)), mv(torch.from_numpy(ia))
    win, state = mv(system._prev_win), mv(system.imu_state)
    pre1, v0 = mv(system._prev_pre), mv(system._v0)
    pose0, pose1 = mv(system._prev_pose6), mv(system._last_pose6)
    start = float(np.float32(window[4]))

    def once():
        pre, guess, *_ = lio._lio_prestep(ig, ia, *win, start, state, cfg)
        out = lio._lio_poststep2(state, pre1, pre, pose0, pose1, guess, v0,
                                 False, cfg)
        if device.type == "cuda":
            torch.cuda.synchronize()
        return out

    for _ in range(3):
        once()
    t = time.perf_counter()
    for _ in range(reps):
        once()
    return (time.perf_counter() - t) / reps * 1e3


def phase_lio(dev, out_dir):
    """The LiDAR-inertial path on the lio preset (VLP-16 + IMU, full width)
    over a motion-distorted sequence rendered on the card: LioOdometry,
    the velocity front end, no deskew, predict_imu_rate, and K1/K2 at the
    path's shapes against the LIO map."""
    import dataclasses

    import torch
    from lis_slam_torch.config import lio_config
    from lis_slam_torch.io import synthetic_torch
    from lis_slam_torch.pipeline import driver, lio, odometry
    from lis_slam_torch.utils import se3, se3_np

    n = LIO_SCANS
    base = lio_config()
    cfg = base.replace(matching=dataclasses.replace(base.matching,
                                                    gn_backend="pallas"))
    t = time.perf_counter()
    raw, gt = synthetic_torch.render_sequence_device(
        n, seed=5, radius=60.0, speed=8.0, device=dev, distorted=True,
        n_scan=16, horizon=cfg.sensor.horizon_scan, elevations=VLP16)
    clouds = [p[v].cpu().numpy() for p, _l, v in raw]
    del raw
    imu = [synthetic_torch.imu_rows(gt[i], gt[i + 1]) for i in range(n)]
    R_ext = np.asarray(cfg.imu.extrinsic_rot, np.float64)
    # the IMU in its own frame: imu_to_lidar's extrinsic_rot brings it back
    args = [(clouds[i], imu_t + i * 0.1, (g @ R_ext).astype(np.float32),
             (a @ R_ext).astype(np.float32), i * 0.1)
            for i, (g, a, imu_t) in enumerate(imu)]
    log("lio", f"rendered {n} motion-distorted VLP-16 sweeps (16 x "
        f"{cfg.sensor.horizon_scan}) on the card in "
        f"{time.perf_counter() - t:.2f} s; points/scan {len(clouds[0])} of "
        f"{cfg.sensor.max_raw_points}; {len(imu[0][2])} IMU samples per "
        f"window over {imu[0][2][-1] - imu[0][2][0]:.3f} s")
    counts, ates = {}, {}

    # 1. LioOdometry
    _zero_launches()
    torch.cuda.reset_peak_memory_stats()
    system = lio.LioOdometry(cfg, dev)
    poses = []
    for i, a in enumerate(args):
        poses.append(system.process_scan(*a))
        if i + 1 == 5:
            torch.cuda.synchronize()
            t0, imu0 = time.perf_counter(), system.diag.imu_s
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts["lio"] = _launches()
    peak = torch.cuda.max_memory_allocated()
    poses = torch.stack(poses).cpu().numpy()
    ates["lio"], rpe_t, rpe_r = _accuracy("lio", poses, gt)
    imu_ms = (system.diag.imu_s - imu0) / (n - 5) * 1e3
    log("lio", f"LioOdometry: {(n - 5) / wall:.3f} scans/s ({n - 5} timed "
        f"scans, {wall:.3f} s), ATE {ates['lio']:.4f} m (JAX CPU "
        f"{JAX_ATE['lio']:.4f}, limit {1.5 * JAX_ATE['lio'] + 0.02:.4f}), "
        f"RPE-t {rpe_t:.4f} m, RPE-r {rpe_r:.4f} deg, "
        f"IMU resets {system.diag.n_resets}, IMU chain {imu_ms:.3f} ms/scan "
        f"(host, in the run), K1 launches {counts['lio'][0]}, K2 launches "
        f"{counts['lio'][1]}, peak device memory {peak} bytes")
    check(system.diag.n_resets == 0,
          f"lio: {system.diag.n_resets} IMU resets")
    check(counts["lio"][0] > 0 and counts["lio"][1] > 0,
          f"lio: K1/K2 launches {counts['lio']}")

    # the next scan's IMU window (the last sweep's motion, one period on)
    g, a_, imu_t = imu[-1]
    nxt = (None, imu_t + n * 0.1, (g @ R_ext).astype(np.float32),
           (a_ @ R_ext).astype(np.float32), n * 0.1)
    # the IMU chain of that scan: on the host in float64 (as the run does),
    # and the same functions on the card
    chain = {name: _imu_chain_ms(system, nxt, cfg, torch.device(d), dt)
             for name, d, dt in (("host f64", "cpu", torch.float64),
                                 ("card f64", dev.type, torch.float64),
                                 ("card f32", dev.type, torch.float32))}
    log("lio", "IMU chain (prestep + two-window poststep) per scan, "
        "isolated: " + ", ".join(f"{k} {v:.3f} ms" for k, v in chain.items()))

    # 4. predict_imu_rate on the next window
    rate = system.predict_imu_rate(*nxt[1:4])
    check(rate.shape == (len(imu_t), 6) and bool(torch.isfinite(rate).all())
          and rate.device.type == "cuda",
          f"predict_imu_rate: {tuple(rate.shape)} on {rate.device}")
    path = float(torch.linalg.vector_norm(rate[-1, 3:] - rate[0, 3:]))
    log("lio", f"predict_imu_rate: ({rate.shape[0]}, 6) finite poses on the "
        f"card, {path:.4f} m over the window (ground truth "
        f"{8.0 * (imu_t[-1] - imu_t[0]):.4f} m)")

    # K1 and K2 at the LIO path's shapes: the last scan's matched clouds
    # (gyro-deskewed) against the LIO map, at the run's last pose
    g_l = imu[-1][0]
    sin = driver.pad_scan(clouds[-1], cfg, dev, imu_time=args[-1][1],
                          imu_gyro=g_l, scan_start=args[-1][4])
    qc, qc_mask, qs, qs_mask = odometry._matched_clouds(
        odometry.preprocess(sin, cfg), cfg)
    st = system.state
    inp = dict(corner=(qc, qc_mask, st.map_corner, st.map_corner_mask),
               surf=(qs, qs_mask, st.map_surf, st.map_surf_mask),
               pose=torch.as_tensor(poses[-1], dtype=torch.float32,
                                    device=dev))
    T = se3.pose_to_matrix(inp["pose"])
    k = cfg.matching.nn_cache_k
    for mode, (q, _m, ref, ref_mask) in (("corner", inp["corner"]),
                                         ("surf", inp["surf"])):
        _check_knn("lio K1", f"{mode} Q{q.shape[0]} N{ref.shape[0]} k{k} "
                   "cap4", se3.transform_points(T, q).contiguous(), ref,
                   ref_mask, k, 4.0)
    _check_gn_real("lio K2", "LIO map", inp, cfg)
    del inp, sin

    # 2. the velocity front end, body velocity and rate from ground truth
    cv = cfg.replace(imu=dataclasses.replace(cfg.imu, use_imu=False,
                                             deskew_mode="velocity"))
    _zero_launches()
    state = odometry.init_state(cv, dev)
    vposes = []
    for i in range(n):
        R0 = se3_np.pose_to_matrix(gt[i])[:3, :3]
        vel = R0.T @ (gt[i + 1][3:] - gt[i][3:]) / 0.1
        sin = driver.pad_scan(clouds[i], cv, dev, velocity=vel,
                              angular_rate=imu[i][0][0])
        state, out = odometry.odom_step(state, sin, cv)
        vposes.append(out.pose)
    torch.cuda.synchronize()
    counts["velocity"] = _launches()
    ates["velocity"], rpe_t, rpe_r = _accuracy(
        "velocity", torch.stack(vposes).cpu().numpy(), gt)
    log("lio", f"velocity front end: ATE {ates['velocity']:.4f} m (JAX CPU "
        f"{JAX_ATE['velocity']:.4f}, limit "
        f"{1.5 * JAX_ATE['velocity'] + 0.02:.4f}), RPE-t {rpe_t:.4f} m, RPE-r "
        f"{rpe_r:.4f} deg, K1 launches {counts['velocity'][0]}, K2 "
        f"launches {counts['velocity'][1]}")

    # 3. no deskew, as a contrast
    cn = cfg.replace(imu=dataclasses.replace(cfg.imu, use_imu=False))
    _zero_launches()
    res = driver.replay_odometry(clouds, cn, warmup=5, device=dev)
    counts["none"] = _launches()
    ates["none"], rpe_t, rpe_r = _accuracy("none", res.poses, gt)
    log("lio", f"no deskew (contrast): {res.scans_per_sec:.3f} scans/s, ATE "
        f"{ates['none']:.4f} m (JAX {JAX_ATE['none']:.4f}), RPE-t "
        f"{rpe_t:.4f} m, RPE-r {rpe_r:.4f} deg")
    with open(os.path.join(out_dir, "lio.json"), "w") as f:
        json.dump({"ate_m": ates, "jax_cpu_ate_m": JAX_ATE,
                   "imu_chain_ms": chain, "lio_poses": poses.tolist(),
                   "gt": gt[:n].tolist()}, f)
    for mode in ("lio", "velocity"):
        bar = 1.5 * JAX_ATE[mode] + 0.02
        check(ates[mode] <= bar, f"{mode}: ATE {ates[mode]} > {bar}")
    return counts


def phase_greedy(scans, gt, cfg, dev, vec_poses):
    """The reference-faithful greedy feature selection on the first scans
    of the main circuit, against the vectorized selection's run."""
    import dataclasses

    from lis_slam_torch.pipeline import driver

    n = GREEDY_SCANS
    c = cfg.replace(
        feature=dataclasses.replace(cfg.feature, greedy_selection=True),
        matching=dataclasses.replace(cfg.matching, gn_backend="pallas"))
    _zero_launches()
    res = driver.replay_odometry(scans[:n], c, warmup=2, device=dev)
    counts = _launches()
    ate, rpe_t, rpe_r = _accuracy("greedy", res.poses, gt)
    gap = np.linalg.norm(res.poses[:, 3:] - vec_poses[:n, 3:], axis=1)
    log("greedy", f"{n} scans: {res.scans_per_sec:.3f} scans/s, ATE "
        f"{ate:.4f} m, RPE-t {rpe_t:.4f} m, RPE-r {rpe_r:.4f} deg, per-scan "
        f"position gap to the vectorized run max {gap.max():.5f} m, K1 "
        f"launches {counts[0]}, K2 launches {counts[1]}")
    check(ate < ATE_MAX, f"greedy: ATE {ate} >= {ATE_MAX}")
    check(gap.max() < GREEDY_GAP_M, f"greedy: {gap.max()} m from the "
          "vectorized run")
    check(counts[0] > 0 and counts[1] > 0, f"greedy: launches {counts}")
    return {"greedy": counts}


def _slam_drift_hook(pose6, idx):
    """bench.py:216-221: a yaw error about the world origin growing 3e-4
    rad per scan (~0.3% of travel, inside the 1% candidate gate)."""
    from lis_slam_torch.utils import se3_np

    th = 3e-4 * idx
    c, s = np.cos(th), np.sin(th)
    Td = np.eye(4)
    Td[:2, :2] = [[c, -s], [s, c]]
    return se3_np.matrix_to_pose(Td @ se3_np.pose_to_matrix(pose6))


def _render_plaza(cfg, dev):
    """The plaza lap of bench.py:145-201 on the card: SLAM_LAP scans, then
    SLAM_EXTRA along the start of the lap on a second noise render; each
    compacted as the bench's loader does, with its labels."""
    import torch
    from lis_slam_torch.io import synthetic, synthetic_torch
    from lis_slam_torch.pipeline import driver

    n = SLAM_LAP
    world = synthetic_torch.to_device_world(synthetic_torch.plaza_world(),
                                            dev)
    gt = synthetic.circular_trajectory(
        n + 1, radius=10.0, speed=2.0 * np.pi * 10.0 / (n * 0.1))
    seq = []
    for lap_seed, count in ((9, n), (11, SLAM_EXTRA)):
        gen = torch.Generator(device=dev)
        gen.manual_seed(lap_seed)
        for i in range(count):
            p, lab, v = synthetic_torch.render_scan_device(
                world, torch.as_tensor(gt[i]), gen)
            seq.append((driver.compact_scan(p, v, cfg),
                        driver.compact_labels(p, v, lab, cfg)))
    gt_seq = np.concatenate([gt[:n], gt[:SLAM_EXTRA]])
    return seq, gt_seq


def _graph_lm_ms(system, device, reps=3):
    """Host-clock ms of the final pose-graph LM solve (graph/pose_graph.py
    optimize) with the run's final factors, on `device`."""
    import torch
    from lis_slam_torch.graph import pose_graph

    gb = pose_graph.GraphBuilder(
        system.cfg.graph, system.graph.max_nodes, system.graph.max_edges,
        system.graph.max_priors, device=device)
    gb.nodes = [n.copy() for n in system.graph.nodes]
    gb.edges, gb.priors = list(system.graph.edges), list(system.graph.priors)
    gb.optimize()  # warm-up
    t = time.perf_counter()
    for _ in range(reps):
        gb.nodes = [n.copy() for n in system.graph.nodes]
        gb.optimize()  # ends with the nodes' readback
    return (time.perf_counter() - t) / reps * 1e3, gb.to_device().nodes.shape[0]


def _check_slam_kernels(system, cfg, dev):
    """K1 and K2 at the back end's shapes, against their plain versions:
    K1 at k=1 (dynamic removal) on the local map with holes and on an
    empty map; K1 bit-equal against the submap-sized targets (geometric
    surf N 131072, the semantic registration's 3 x 32768 = 98304) at Q
    8192; K2 with weights in [0.5, 2] at Q 8192. Returns the worst error
    of each kernel (K1 distance, K2 scaled)."""
    import torch
    from lis_slam_torch.ops import gn_cuda, knn_cuda, voxel
    from lis_slam_torch.utils import se3

    worst_k1 = worst_k2 = 0.0
    subs = system.collector.submaps
    check(len(subs) >= 3, f"slam: {len(subs)} submaps")
    prev, cur = subs[1], subs[2]
    Ti = se3.transform_inverse(torch.as_tensor(
        cur.pose_init.astype(np.float32), device=dev))
    T = torch.as_tensor(cur.pose_init.astype(np.float32), device=dev)
    q, _qm, _ = voxel.voxel_downsample(
        se3.transform_points(Ti, cur.surf_xyz), cur.surf_mask,
        cfg.submap.refine_surf_leaf, cfg.submap.matched_surf_capacity)
    qw = se3.transform_points(T, q).contiguous()
    sem = system.fstate.sem
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    holes = sem.surf_mask & (torch.rand(sem.surf_mask.shape, generator=gen,
                                        device=dev) > 0.1)
    t_sem = torch.cat([prev.class_xyz[c] for c in (0, 1, 2)]).contiguous()
    t_sem_m = torch.cat([prev.class_mask[c] for c in (0, 1, 2)]).contiguous()
    k = cfg.matching.nn_cache_k
    cases = [
        (f"dynamic removal Q{qw.shape[0]} N{sem.surf_pts.shape[0]} k1 nocap "
         "holes", qw, sem.surf_pts, holes, 1, None),
        (f"dynamic removal Q{qw.shape[0]} empty map k1 nocap", qw,
         sem.surf_pts, torch.zeros_like(holes), 1, None),
        (f"geo registration Q{qw.shape[0]} N{prev.surf_xyz.shape[0]} k{k} "
         "cap4", qw, prev.surf_xyz, prev.surf_mask, k, 4.0),
        (f"sem registration Q{qw.shape[0]} N{t_sem.shape[0]} k{k} cap4", qw,
         t_sem, t_sem_m, k, 4.0),
    ]
    for name, qq, ref, mask, kk, cap in cases:
        err, _ms_k, _ms_p = _check_knn("slam K1", name, qq, ref, mask, kk, cap)
        d, _i, _x = knn_cuda.knn(qq, ref, mask, k=kk, max_sq_dist=cap)
        dp, _ip, _xp = knn_cuda.knn_plain(qq, ref, mask, k=kk,
                                          max_sq_dist=cap)
        check(bool(torch.equal(d, dp)), f"slam K1 {name}: not bit-equal")
        if not bool(mask.any()):
            check(bool(torch.isinf(d).all()),
                  f"slam K1 {name}: empty map gave a finite distance")
        worst_k1 = max(worst_k1, err)

    # K2 with non-unit weights at the refinement's Q = 8192
    n_q, n_map = cfg.submap.matched_surf_capacity, 65536
    buf, buf_mask, world, rng = _gn_world("surf", n_map, dev, 11)
    ref, _, ref_mask = voxel.voxel_merge_aged(
        buf, buf_mask, torch.zeros_like(buf),
        torch.zeros(n_map, dtype=torch.int32, device=dev),
        torch.zeros_like(buf_mask), 0, 1, cfg.voxel.mapping_surf_leaf, n_map)
    pose_true = torch.tensor([0.01, -0.02, 0.08, 0.5, -0.3, 0.05], device=dev)
    sel = world[rng.integers(0, len(world), n_q)]
    sel = sel + rng.normal(0, 0.02, sel.shape).astype(np.float32)
    qs = se3.transform_points(se3.transform_inverse(se3.pose_to_matrix(
        pose_true)), torch.from_numpy(sel).to(dev)).contiguous()
    pose = pose_true + torch.tensor([0.002, -0.001, 0.004, 0.05, -0.03, 0.01],
                                    device=dev)
    d, _, cand = knn_cuda.knn(
        se3.transform_points(se3.pose_to_matrix(pose), qs).contiguous(), ref,
        ref_mask, k=k, max_sq_dist=4.0)
    w = torch.from_numpy(rng.uniform(0.5, 2.0, n_q).astype(np.float32)).to(dev)
    args = (qs, torch.from_numpy(rng.uniform(size=n_q) > 0.1).to(dev), cand,
            (d < 4.0).contiguous(), w,
            gn_cuda.pack_scalars(pose, cfg.matching, "surf").contiguous(),
            "surf", k)
    H, g, nv = gn_cuda.gn_partials(*args)
    Hp, gp, nvp = gn_cuda.gn_partials_plain(*args)
    torch.cuda.synchronize()
    eh, eg = _scaled_err(H, g, Hp, gp)
    log("slam K2", f"surf Q{n_q} N{n_map} k{k}, weights in [0.5, 2]: n_valid "
        f"{int(nv)} (plain {int(nvp)}), scaled err H {eh:.3g} g {eg:.3g}")
    check(int(nvp) > n_q // 4, f"slam K2: only {int(nvp)} valid rows")
    check(int(nv) == int(nvp), "slam K2: n_valid differs")
    check(eh <= GN_ATOL and eg <= GN_ATOL,
          f"slam K2 weighted: scaled error H {eh:.3g} g {eg:.3g}")
    worst_k2 = max(eh, eg)
    return worst_k1, worst_k2


# A synchronizing CUDA call is charged to the innermost of these functions
# on its Python stack.
SYNC_STAGES = {
    "_odom_step_impl": "front end", "refine_step": "refine",
    "compute_descriptors": "descriptors", "select_descriptor": "descriptors",
    "slam_step": "keyframe step, other", "gate": "loop scoring",
    "score_async": "loop scoring", "result_to_candidate": "loop scoring",
    "_verify_loop_device": "verify ICP",
    "_register_submaps_dispatch": "registration",
    "optimize_async": "LM", "add_keyframe": "submap close",
    "_on_submap": "submap close", "_consume": "window fetch",
}


def _slam_syncs(cfg, seq, dev):
    """Host syncs of a SemanticSlam run over `seq` (scan 0 through
    flush_pipeline, drift hook on, as the timed run), by stage; every
    synchronizing CUDA call warns once under the sync debug mode."""
    import torch
    from lis_slam_torch.pipeline import slam

    counts: dict[str, int] = {}

    def show(message, category, filename, lineno, file=None, line=None):
        if "synchronizing" not in str(message):
            return
        f, stage = sys._getframe(1), "other"
        while f is not None:
            if f.f_code.co_name in SYNC_STAGES:
                stage = SYNC_STAGES[f.f_code.co_name]
                break
            f = f.f_back
        counts[stage] = counts.get(stage, 0) + 1

    system = slam.SemanticSlam(cfg, pose_hook=_slam_drift_hook, device=dev)
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for i, (scan, labels) in enumerate(seq):
                system.process_scan(scan, gt_labels=labels, timestamp=i * 0.1)
            system.flush_pipeline()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return dict(sorted(counts.items(), key=lambda kv: -kv[1])), system


def phase_slam(dev, out_dir):
    """SemanticSlam at full width on the plaza lap with injected drift;
    accuracy against the JAX package's bar, then the kernels at the back
    end's shapes and the LM on the card vs the host."""
    import dataclasses

    import torch
    from lis_slam_torch.config import SensorConfig, SlamConfig
    from lis_slam_torch.pipeline import slam, trajectory

    base = SlamConfig().replace(sensor=SensorConfig(max_raw_points=65536))
    cfg = base.replace(matching=dataclasses.replace(base.matching,
                                                    gn_backend="pallas"))
    t = time.perf_counter()
    seq, gt = _render_plaza(cfg, dev)
    torch.cuda.synchronize()
    log("slam", f"rendered and compacted {len(seq)} plaza scans on the card "
        f"in {time.perf_counter() - t:.2f} s; points/scan "
        f"{int(seq[0][0].valid.sum())} of {cfg.sensor.max_raw_points}")

    warm = slam.SemanticSlam(cfg, pose_hook=_slam_drift_hook, device=dev)
    for i in range(SLAM_WARMUP):
        warm.process_scan(seq[i][0], gt_labels=seq[i][1], timestamp=i * 0.1)
    warm.finish()
    del warm

    _zero_launches()
    torch.cuda.reset_peak_memory_stats()
    system = slam.SemanticSlam(cfg, pose_hook=_slam_drift_hook, device=dev)
    system.process_scan(seq[0][0], gt_labels=seq[0][1], timestamp=0.0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(1, len(seq)):
        system.process_scan(seq[i][0], gt_labels=seq[i][1],
                            timestamp=i * 0.1)
    system.flush_pipeline()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    res = system.finish()
    counts = _launches()
    peak = torch.cuda.max_memory_allocated()
    n = len(seq)
    check(res.poses.shape == (n, 6) and bool(np.isfinite(res.poses).all()),
          "slam: corrected poses not finite (n, 6)")
    gt_rel = trajectory.relative_to_first(gt)
    ate = trajectory.ate_rmse(res.poses, gt_rel, align=True)
    raw = trajectory.ate_rmse(res.raw_poses, gt_rel, align=True)
    rpe_t, rpe_r = trajectory.rpe(res.poses, gt_rel)
    stages = {k: round(v["total_ms"], 3)
              for k, v in system.timer.report().items()}
    bar = 1.5 * JAX_SLAM_ATE + 0.02
    log("slam", f"{(n - 1) / wall:.3f} scans/s ({n - 1} timed scans through "
        f"flush_pipeline, {wall:.3f} s); ATE aligned corrected {ate:.4f} m, "
        f"raw {raw:.4f} m (JAX CPU corrected {JAX_SLAM_ATE:.4f}, limit "
        f"{bar:.4f}); RPE-t {rpe_t:.4f} m, RPE-r {rpe_r:.4f} deg; submaps "
        f"{res.n_submaps}, loop factors {res.n_loops}, keyframes "
        f"{len(system.keyframes)}; K1 launches {counts[0]}, K2 launches "
        f"{counts[1]}; peak device memory {peak} bytes")
    log("slam", "stage totals ms: " + json.dumps(stages))

    # host syncs by stage, over a second untimed run of the whole lap
    syncs, s2 = _slam_syncs(cfg, seq, dev)
    n_kf = len(s2.keyframes)
    runs = {k: v.count for k, v in s2.timer.stats.items()}
    log("slam", f"host syncs over the {n} scans through flush_pipeline, by "
        f"stage: {json.dumps(syncs)}; {n_kf} keyframes, "
        f"{runs.get('loop_verify', 0)} verifications, "
        f"{runs.get('submap_register', 0)} registrations, "
        f"{runs.get('graph_optimize', 0)} LM solves; front end "
        f"{syncs.get('front end', 0) / n:.1f} per scan, the rest "
        f"{(sum(syncs.values()) - syncs.get('front end', 0)) / max(n_kf, 1):.1f}"
        " per keyframe")
    check(runs.get("loop_verify", 0) > 0 and runs.get("graph_optimize", 0) > 0,
          f"slam: the sync count saw no verification or LM solve ({runs})")
    del s2

    lm = {"card": _graph_lm_ms(system, dev),
          "host": _graph_lm_ms(system, torch.device("cpu"))}
    log("slam", f"pose-graph LM, final graph ({len(system.graph.nodes)} nodes "
        f"padded to {lm['card'][1]}, {len(system.graph.edges)} edges), "
        f"float32: card {lm['card'][0]:.3f} ms, host {lm['host'][0]:.3f} ms "
        f"(the run solved on {system.graph.device})")
    with open(os.path.join(out_dir, "slam.json"), "w") as f:
        json.dump({"ate_corrected_m": ate, "ate_raw_m": raw,
                   "jax_cpu_ate_corrected_m": JAX_SLAM_ATE,
                   "rpe_t_m": rpe_t, "rpe_r_deg": rpe_r,
                   "scans_per_s": (n - 1) / wall, "stages_total_ms": stages,
                   "n_submaps": res.n_submaps, "loop_factors": res.n_loops,
                   "keyframes": len(system.keyframes), "peak_bytes": peak,
                   "lm_ms": {d: v[0] for d, v in lm.items()},
                   "syncs_by_stage": syncs, "poses": res.poses.tolist(),
                   "raw_poses": res.raw_poses.tolist(),
                   "gt": gt_rel.tolist()}, f)
    check(res.n_loops >= 1, "slam: no loop factor")
    check(ate < raw, f"slam: corrected ATE {ate} >= raw {raw}")
    check(ate <= bar, f"slam: corrected ATE {ate} > {bar}")
    check(counts[0] > 0 and counts[1] > 0, f"slam: launches {counts}")
    err = _check_slam_kernels(system, cfg, dev)
    return {"slam": counts}, err


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scans", type=int, default=60)
    ap.add_argument("--out", default=os.path.join(ROOT, "smoke_out"),
                    help="directory for build logs and per-scan results")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    try:
        import torch  # noqa: F401
        import lis_slam_torch  # noqa: F401
    except ImportError as e:
        print(f"FAIL: {e} (run from a checkout of the repository)",
              file=sys.stderr)
        return 1
    phase = "device"
    try:
        card = phase_device()
        os.makedirs(args.out, exist_ok=True)
        phase = "build"
        phase_build(args.out)

        phase = "data"
        from lis_slam_torch.config import SensorConfig, SlamConfig
        from lis_slam_torch.io import synthetic_torch
        from lis_slam_torch.pipeline import driver

        dev = torch.device("cuda", 0)
        # the benchmark's operating point: 64 x 1800 HDL-64 sweeps, rings
        # downsampled by the loader and compacted to a 65536-row buffer
        cfg = SlamConfig().replace(sensor=SensorConfig(max_raw_points=65536))
        t = time.perf_counter()
        raw, gt = synthetic_torch.render_sequence_device(
            args.scans, seed=5, radius=60.0, speed=8.0, device=dev)
        scans = [driver.compact_scan(p, v, cfg) for p, _l, v in raw]
        del raw
        torch.cuda.synchronize()
        log("data", f"rendered and compacted {len(scans)} scans on the card "
            f"in {time.perf_counter() - t:.2f} s; points/scan "
            f"{int(scans[0].valid.sum())} of {cfg.sensor.max_raw_points}")
        inp = _build_inputs(scans, gt, cfg, dev)

        phase = "K1"
        k1 = phase_k1(inp, dev)
        phase = "K2"
        k2 = phase_k2(inp, cfg, dev)
        del inp
        phase = "main"
        launches, vec_poses = phase_main(scans, gt, cfg, dev, args.out)
        phase = "lio"
        launches.update(phase_lio(dev, args.out))
        phase = "greedy"
        launches.update(phase_greedy(scans, gt, cfg, dev, vec_poses))
        del scans
        phase = "slam"
        slam_launches, (k1_slam, k2_slam) = phase_slam(dev, args.out)
        launches.update(slam_launches)
        k1["max_abs_err"] = max(k1["max_abs_err"], k1_slam)
        k2["max_abs_err"] = max(k2["max_abs_err"], k2_slam)
    except BaseException as e:  # any failure: report and exit nonzero
        if isinstance(e, SystemExit) and isinstance(e.code, str):
            print(f"FAIL [{phase}]: {e.code}", file=sys.stderr)
        else:
            traceback.print_exc()
            print(f"FAIL [{phase}]: {e!r}", file=sys.stderr)
        return 1
    kernels = []
    for j, (name, source, replaces, res) in enumerate((
            ("K1 exact kNN", K1_SOURCE, K1_REPLACES, k1),
            ("K2 fused GN accumulation", K2_SOURCE, K2_REPLACES, k2))):
        per_path = {p: c[j] for p, c in launches.items()}
        kernels.append(dict(name=name, route="cuda", source=source,
                            replaces=replaces,
                            launches=sum(per_path.values()),
                            launches_per_path=per_path, **res))
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
