#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (lis_slam_torch) on one NVIDIA GPU.

Drives the port's front-end odometry step, its LiDAR-inertial path, the
batched multi-sequence replay, the full SLAM system, the KITTI-replay CLI,
checkpoint/resume, NDT, RangeNet training, the multi-device layer, the
unfused projection pair, the synthetic RangeNet recipe and a 1000-scan
endurance run with a mid-run resume, with the three
hand-written CUDA kernels, through these phases (one or more lines each;
projection runs after K2, recipe last):

  1. device - torch and CUDA versions, the card's name and power limit;
  2. build  - nvcc builds csrc/knn.cu (K1, exact kNN), csrc/gn.cu (K2,
              fused Gauss-Newton accumulation) and csrc/gn_solve.cu (K3,
              the scheduled solver's GN solve and masked update) from the
              checkout, at once;
  3. K1     - kernel against its plain PyTorch version (bit-equal) at the
              front end's shapes, on a morton-ordered map built by
              voxel_merge_aged with queries morton-sorted as scan_to_map
              sorts them;
  4. K2     - kernel as the solvers on the card launch it (B = 1, rows
              and sums in float64, the rows K3 writes) against its plain
              version in float64, one cloud per launch and both in the
              main path's one launch per GN iteration, on K1's candidates;
  5. main   - the synthetic HDL-64 circuit (make_world(seed=5), radius 60 m,
              8 m/s, 60 scans, rendered on the card) through
              pipeline.driver.replay_odometry -> odometry.odom_step, once
              with gn_backend="xla" (K1 + plain GN) and once with "pallas"
              (K1 + K2 + K3, the GN state on the card); then each scan
              stepped from the same state under both backends, the host
              syncs per scan, and K3 against its plain version on the
              normal equations recorded during three scans (B = 1);
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
  8. batched - parallel/batched.replay_batched at full width: 8 lanes of
              24 circuit scans (lanes 0 and 1 the same sequence, lane
              b >= 2 from scan 4 (b - 1)), default config (uniform step,
              8 iterations, refresh at 3, keyframe merge every 4 steps),
              under both GN backends (pallas: K1 + K2 + K3; xla: K1 + K3):
              lanes 0/1 bit-equal, every lane's ATE; lane 0 with a merge
              every scan against odometry.odom_step_uniform; the uniform
              step's ATE beside odom_step's; no host sync inside a warm
              batched_odom_step (sync debug mode "error"); K1/K2/K3
              launches and all CUDA activities of one step at B = 1 and
              B = 8 (equal); aggregate scans/s at B = 1, 8, 32 beside
              replay_odometry's, peak memory, the step's device busy share;
              then K3 against its plain version on the normal equations
              recorded during a step at B = 1, 8 and 32 (times, an empty
              launch's, the wrapper's host ms at B = 8), and K1 / K2 at
              the batched shapes; with --baseline, that checkout's
              replay of the same lanes (final positions against this
              one's), busy share and scans/s in turns;
  9. slam   - the full SLAM system (pipeline/slam.py SemanticSlam: front
              end, semantic refinement, submaps, EPSC loop closure, ICP
              verification, pose graph) on the JAX bench's plaza lap
              (bench.py:123-258): 100 HDL-64 scans of the exactly periodic
              10 m circle plus 40 past the closure on a second noise
              render, rendered on the card, ground-truth labels, the
              bench's yaw drift injected through pose_hook, default
              SlamConfig with gn_backend "pallas"; the same run again,
              untimed, with its host syncs counted by stage; then K1 and
              K2 at the back end's shapes against their plain versions,
              and the pose-graph LM on the card and on the host;
  10. semantic - RangeNet: the in-repo slim checkpoint labelling one plaza
              scan (64 x 1800) per raw point against ground truth, and
              the keyframe path's labelling of the front end's projection;
              the full-size darknet53 (default SemanticConfig, seeded
              random weights) at 64 x 2048 x 5, batch 1, bf16: device and
              call ms per inference, parameters, FLOPs, TFLOP/s against
              the bf16 peak, argmax against float32;
 11. slam_infer - the slam lap with cfg.semantic.enabled and no labels,
              so the checkpoint labels every keyframe, held to the JAX
              package's run of the same mode; then 40 lap scans with the
              darknet53 weights as rangenet_params (scans/s).
 12. lio_slam - SemanticSlam with cfg.imu.use_imu on the slam phase's lap:
              (a) the JAX bench's lio_full_slam mode (bench.py:415-466:
              constant 12-sample IMU windows of the lap's motion, no
              drift hook), held to the JAX package's run (ATE, resets,
              submaps, loop factors), scans/s, host IMU chain ms, host
              syncs by stage; (b) the same scans without the IMU, with
              the debug dump; (c) motion-distorted sweeps with their IMU
              rows, fused and LiDAR-only (contrasts); (d)
              predict_imu_rate's times and its start against the nav
              state; (e) GPS fixes every 5th scan on a drifting lap
              without loop closure (ATE with < 0.7 x without), with the
              debug dump; (f) optimize_cg against the dense LM and its
              times on the host and the card at 512 and 1024 nodes; K1/K2
              at the path's shapes.
 13. cli    - the port's KITTI-replay CLI (python -m lis_slam_torch.run_kitti,
              called in-process as run_kitti.main) on the plaza lap rendered
              at the kitti preset's full HDL-64 width (64 x 1800, 150000-row
              buffer) and written as KITTI sequence 00 (.bin, poses, calib,
              times): native loader, pinned uploads, SemanticSlam with the
              fused GN iteration (--gn-backend pallas), pred.txt and
              map.pcd read back, corrected ATE held to the JAX package's
              run (scripts/cli_accuracy_bars.py), scans/s and peak
              memory; K1/K2 at the CLI's back-end shapes;
 14. checkpoint - the slam phase's run uninterrupted, and saved after
              scan 70 (keyframe clouds already released), loaded into a
              fresh SemanticSlam and continued: raw poses within 1e-4,
              corrected within 5e-3, the same submaps and loop factors;
              the file's size, save and load ms;
 15. endurance - in a process of its own: the JAX bench's endurance
              section (bench.py:274-400) through the port: 10 plaza laps
              of 100 scans (1000), even laps the slam phase's render, odd
              laps a second full-lap render (its first 40 scans the slam
              phase's extra ones), ground-truth labels, the drift hook on
              the global scan index: scans/s, lap walls, the flush tail,
              corrected and raw ATE and per-lap ATE held to the JAX
              package's CPU run
              (scripts/endurance_accuracy_bars.py), loop factors per lap,
              submaps, keyframes and releases, the graph's size and solver
              route, host syncs per lap, device memory after each lap
              against a reckoning from the config's capacities, peak host
              RSS; a run stopped after scan 500, saved, loaded into a
              fresh system and continued, against the uninterrupted one;
              K1/K2 against their plain versions at lap 10's shapes; the
              centroid voxel downsample (twice bit-equal on the card, and
              against the host) and the two random downsample masks.
 16. ndt    - build_ndt + ndt_align between two plaza submaps on the card
              against the same calls on the host (transform within 1e-4,
              the same iterations and convergence), ms a call;
 17. train  - five RangeNet training steps (train/seg_train.py) at the
              full darknet53 width, 64 x 2048 x 5 bf16, batch 2, on one
              seeded batch: the loss falls; ms a step, peak memory; the
              trained weights as SemanticSlam's rangenet_params label a
              plaza scan.
 18. sharded - the multi-device layer (parallel/mesh.py) with ranks
              started by mesh.spawn (processes; the kernels built once
              above, each rank loading them): (a) a world of one over
              NCCL: replay_batched(mesh=make_mesh(1)) of the batched
              phase's 8 lanes x 24 circuit scans (pallas) bit-equal to
              replay_batched(mesh=None) in the same rank; (b) two ranks
              sharing the card over gloo, 4 lanes a rank: lanes 0/1
              bit-equal, every lane within 5e-3 m of the unsharded replay
              and ATE < 0.1 m, K1/K2/K3 launched and counted on each rank,
              a step without a host sync, K1/K2/K3 against their plain
              versions at each rank's shapes (ranks in turn); (c)
              make_sharded_train_step at the full darknet53 width,
              64 x 2048 x 5, batch 2, the train phase's seeded weights and
              batch, on (data 2), (model 2) and (space 2) over the two
              ranks and on the world of one: one float32 step against the
              unsharded step (loss 1e-5, grad norm 1e-4 relative,
              parameters 2e-3 x lr where the gradient is above 5% of its
              leaf's largest), then five bf16 steps (the loss falls; ms a
              step, peak memory per rank); (d) the port's
              dryrun_multichip(4) over gloo (data 1 x model 2 x space 2),
              three calls with bit-identical losses and poses; (e)
              cuDNN's bf16 conv and transposed conv at RangeNet's narrowest
              widths (one output column, where torch's CPU bf16 kernel
              reads unwritten memory): exact zeros on zero inputs, within
              one bf16 ulp of the float32 conv rounded once on random ones.
 19. projection - ops/projection.py project + extract (the unfused pair)
              on a full HDL-64 plaza scan (64 x 1800, P = 115200) with its
              labels in the rel_time channel: the card against the host
              on the same pretreated points, bit-equal outside the pixels
              of the points whose column the card's float32 atan2 moves
              (counted, at most 1e-4 of the valid points); the card's
              fused project_and_extract against its
              pair (masks, counts, columns equal; ranges within 0.02 m);
              ms a call of both (CUDA events).
 20. recipe - the synthetic RangeNet recipe (train/recipe.py, the JAX
              script scripts/train_rangenet_synthetic.py's): 88 labelled
              64 x 1824 images rendered on the card, 2500 steps of the
              slim net on 512-wide crops, batch 8, bf16, warm-up + cosine
              Adam with a global-norm clip: render s, ms a step, the loss
              every 100 steps (finite, falling), peak memory, held-out
              mIoU (>= 0.95) beside the shipped checkpoint's; the
              checkpoint written and read back (load_checkpoint), its
              per-point label accuracy on a plaza scan (> 0.8), and the
              slam lap with SemanticSlam(rangenet_params=...) labelling
              every keyframe (the slam_infer bar, >= 1 loop factor,
              K1/K2 launched).

Every kernel case (K1 at each path's shapes, K2's one launch per GN
iteration at the front end's, the LIO path's, the refinement's, the
batched replay's and each sharded rank's, K3 at the front end's B = 1,
the batched replay's B = 1, 8, 32 and each sharded rank's) is timed
four ways: device ms per call (torch.profiler's CUDA activities,
summed: the kernel's own time),
call ms (CUDA events around back-to-back calls: the host's pace where it
is the slower), plain ms (its plain version on the card) and its bound
(bytes moved once over 3.35 TB/s, or the operations these inputs need
over 67 TFLOP/s float32 and 34 TFLOP/s float64, the larger); K1 also
prints the share of map tiles it skipped, K3 an empty launch's device
ms beside its bound (the practical floor). No single PyTorch call
computes K1's or K2's function, so their library_ms is null with the
reason; torch.cdist + torch.topk is timed beside K1 as information only.
K3's library_ms is torch.linalg.eigh + torch.linalg.solve on the same
(B, 6, 6) normal equations, part of its function.
With --baseline DIR (another checkout, e.g. the parent commit unpacked)
each case also times that checkout's kernels on the same inputs, in
turns: baseline, this, this, baseline; the batched phase also replays
its lanes with that checkout and times its busy share and scans/s.

Then one JSON line with each kernel's launches (in all, and per path;
the sharded phase's per rank: sharded_w1_r0, sharded_w2_r0,
sharded_w2_r1),
error against its plain version, its main case's times and every case,
and last the device JSON line. Any failed phase exits nonzero with no
result line; so does a machine without a CUDA device, and a directory
without the lis_slam_torch package.

    python3 chip_smoke.py [--scans 60] [--out smoke_out] [--baseline DIR]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
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
K3_SOURCE = "lis_slam_torch/csrc/gn_solve.cu"
# no Pallas kernel: the XLA solve and masked update it replaces
K3_REPLACES = "lis_slam_tpu/ops/scan_match.py:181"
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
# the same lap with labels inferred by the in-repo RangeNet checkpoint
# (cfg.semantic.enabled, no gt_labels), the JAX package on a CPU:
#   python scripts/full_slam_infer_accuracy_bars.py
# (numpy renderer, gn_backend "xla", aligned ATE). Bars as JAX_SLAM_ATE's.
JAX_SLAM_INFER = {"ate_corrected_m": 0.02736524896292764,
                  "ate_raw_m": 0.15214977157674042, "n_submaps": 10,
                  "loop_factors": 6, "keyframes": 47}
SEM_ACC_MIN = 0.8  # per-point label accuracy (tests/test_semantic_infer.py)
DARKNET_PARAMS = 46_565_940  # the released darknet53, with batch statistics
# NVIDIA's dense bf16 tensor-core peak of one H100 SXM at 700 W
PEAK_BF16_FLOPS = 989e12
SLAM_INFER_FULL_SCANS = 40  # lap scans with the full-size net (bench.py:575)


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def call_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """ms per call of fn(), by CUDA events around `iters` back-to-back
    calls: host-inclusive. Where the host enqueues more slowly than the
    card runs, this is the host's pace, not the kernel's."""
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


def device_ms(fn, iters: int = 20, warmup: int = 3, tries: int = 3):
    """(ms, ms by activity name): the card's own time per call of
    fn(). torch.profiler traces `iters` calls; the durations of every CUDA
    activity in the window (kernels, copies, sets) are summed and divided
    by `iters`. A window in which the profiler recorded no device activity
    (seen, rarely, on the H100) is traced
    again, up to `tries` windows; then the phase fails."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        by_name: dict[str, float] = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                name = e.name.replace("(anonymous namespace)::", "")
                name = name.split("(")[0][-60:]
                by_name[name] = by_name.get(name, 0.0) + (
                    e.time_range.end - e.time_range.start) / 1e3 / iters
        if by_name:
            return sum(by_name.values()), by_name
    raise AssertionError(f"torch.profiler recorded no CUDA activity in "
                         f"{tries} windows")


# The least time of a kernel's work on one H100 SXM (its published peak
# rates: 3.35 TB/s HBM3, 67 TFLOP/s float32 and 34 TFLOP/s float64
# outside the tensor cores; rates at the full 700 W limit).
PEAK_BYTES_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
PEAK_FP64_FLOPS = 34e12


def _bound(nbytes: float, flops: float, flops_basis: str,
           flops64: float = 0.0):
    """(bound_ms, bound_by, basis) from the bytes moved once and the
    operations these inputs need: `flops` float32 at the float32 peak,
    `flops64` float64 at the float64 peak."""
    t_b = nbytes / PEAK_BYTES_S * 1e3
    t_o = (flops / PEAK_FP32_FLOPS + flops64 / PEAK_FP64_FLOPS) * 1e3
    ops = f"{flops:.0f} flop / 67 TFLOP/s"
    if flops64:
        ops += f" + {flops64:.0f} float64 flop / 34 TFLOP/s"
    basis = (f"bytes {nbytes:.0f} / 3.35 TB/s = {t_b * 1e3:.4f} us; "
             f"{flops_basis} = {ops} = {t_o * 1e3:.4f} us")
    return max(t_b, t_o), ("bytes" if t_b >= t_o else "operations"), basis


def _k1_bound(q, ref, mask, k, cap):
    """K1's bound: each input read once ((Q,3) + (N,3) f32, (N,) bool),
    each output written once ((Q,k) f32 + i32, (Q,k,3) f32); 8 flops per
    distance, over the pairs within the cap (capped) or every query
    against every valid map point (uncapped). Also the brute-force figure,
    8 x Q x N."""
    from lis_slam_torch.ops import knn

    q_n, n = q.shape[0], ref.shape[0]
    nbytes = q_n * 12 + n * 13 + q_n * k * 20
    valid = ref[mask]
    if cap is None:
        pairs, what = q_n * valid.shape[0], "8 x Q x N_valid"
    else:
        pairs = sum(int((knn.sq_dist(q[s:s + 256], valid) < cap).sum())
                    for s in range(0, q_n, 256))
        what = "8 x pairs within the cap"
    ms, by, basis = _bound(nbytes, 8 * pairs, what)
    brute = 8 * q_n * n / PEAK_FP32_FLOPS * 1e3
    return ms, by, f"{basis}; brute force 8 x Q x N = {brute * 1e3:.3f} us"


# flops per masked-in query of K2: an estimate from csrc/gn.cu's
# arithmetic, not a count of its instructions (acos, cos, sqrt as 20
# each): transform 18, re-rank and 5-of-k selection 18 k, centroid and
# covariance 96, eigenvalues ~110, eigenvector ~70, line or plane
# residual and gates ~60, J row ~70, J^T J and J^T r terms 27, block
# sums 28
def _gn_flops(k: int) -> int:
    return 480 + 18 * k


def _k2_bound(clouds, k, lanes=1, f64=False):
    """K2's bound for one GN iteration over `clouds` ((pts, mask, weight
    or None) triples, the lanes' queries flattened): pts, mask, cand (k x
    3 f32) and cand_ok read once per query, the weight only where one is
    passed, two 64-float scalar rows and 43 floats out per lane;
    _gn_flops per masked-in query (an estimate). With `f64` (the lanes
    path's float64 rows) the float32 peak bounds them from below."""
    nbytes = lanes * (2 * 64 * 4 + 43 * 4)
    for p, _m, w in clouds:
        nbytes += p.shape[0] * (12 + 1 + 13 * k + (0 if w is None else 4))
    n_in = sum(int(m.sum()) for _p, m, _w in clouds)
    return _bound(nbytes, n_in * _gn_flops(k),
                  f"~{_gn_flops(k)} (estimated) x masked-in queries"
                  + (" in float64 (at the float32 peak)" if f64 else ""))


K1_NO_LIBRARY = ("no single PyTorch call: torch.cdist + torch.topk is two "
                 "calls, has no cap, and breaks the lowest-index tie rule")
K2_NO_LIBRARY = ("no single PyTorch call computes LOAM's per-query line / "
                 "plane fit reduced to H, g and n_valid")
# per-shape timings of each kernel, filled by the phases
CASES: dict[str, list] = {"K1": [], "K2": [], "K3": []}
BASELINE = None  # --baseline's checkout: pkg, knn_cuda, gn_cuda, gn_solve


def _timed(kernel, tag, name, path, fn, plain, bound, base_fn=None,
           **extra):
    """Time one case of `kernel` ("K1" or "K2"): device ms (baseline,
    this checkout, this checkout, baseline in turns with --baseline), call
    ms, plain ms; record it in CASES[kernel]."""
    if base_fn is not None:
        b1, base_names = device_ms(base_fn)
        n1, names = device_ms(fn)
        n2, _ = device_ms(fn)
        b2, _ = device_ms(base_fn)
        dev = (n1 + n2) / 2
        extra.update(baseline_device_ms=(b1 + b2) / 2,
                     baseline_device_ms_runs=[b1, b2], device_ms_runs=[n1, n2],
                     baseline_call_ms=call_ms(base_fn),
                     baseline_device_ms_by_kernel=base_names)
    else:
        dev, names = device_ms(fn)
    case = dict(path=path, shape=name, device_ms=dev,
                device_ms_by_kernel=names,
                call_ms=call_ms(fn), plain_ms=call_ms(plain, iters=5),
                bound_ms=bound[0], bound_by=bound[1], bound_basis=bound[2],
                library_ms=None, **extra)
    CASES[kernel].append(case)
    more = "".join(f", {k} {v:.4f}" if isinstance(v, float) else ""
                   for k, v in extra.items())
    log(tag, f"{path} {name}: device {dev:.4f} ms (profiler), call "
        f"{case['call_ms']:.4f} ms, plain {case['plain_ms']:.4f} ms, bound "
        f"{bound[0]:.6f} ms by {bound[1]} ({bound[2]}){more}")
    return case


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


def _ptxas_usage(report: str) -> str:
    """The registers, stack and spill lines of an nvcc -Xptxas -v report."""
    return " | ".join(ln.strip() for ln in report.splitlines()
                      if "registers" in ln or "spill" in ln)


def phase_build(out_dir: str) -> None:
    """Build every kernel's source at once (one nvcc each, in threads)."""
    from concurrent.futures import ThreadPoolExecutor

    from lis_slam_torch.ops import cuda_build, gn_cuda, gn_solve, knn_cuda

    def timed(lib_fn):
        t = time.perf_counter()
        lib_fn()
        return time.perf_counter() - t

    kernels = (("knn", knn_cuda._lib, knn_cuda._FLAGS),
               ("gn", gn_cuda._lib, gn_cuda._FLAGS),
               ("gn_solve", gn_solve._lib, gn_solve._FLAGS))
    with ThreadPoolExecutor(len(kernels)) as pool:
        builds = [pool.submit(timed, lib_fn) for _n, lib_fn, _f in kernels]
    for (name, _lib_fn, flags), build in zip(kernels, builds):
        dt = build.result()
        report = cuda_build.build_log(name, flags)
        with open(os.path.join(out_dir, f"build_{name}.log"), "w") as f:
            f.write(report)
        log("build", f"{name}.cu built in {dt:.2f} s; ptxas: "
            + _ptxas_usage(report))


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


def _check_knn(tag, name, q, ref, mask, k, cap, path):
    """K1 against its plain version on one case: distances, indices and
    gathered xyz bit-equal (ties go to the lower index on both sides);
    then its times against its bound (CASES["K1"]). Returns max
    |d - d_plain| over the filled slots (0 when bit-equal)."""
    import torch
    from lis_slam_torch.ops import knn_cuda

    d, i, xyz = knn_cuda.knn(q, ref, mask, k=k, max_sq_dist=cap)
    dp, ip, xp = knn_cuda.knn_plain(q, ref, mask, k=k, max_sq_dist=cap)
    torch.cuda.synchronize()
    fin = torch.isfinite(dp)
    err = (float(torch.max(torch.abs(d[fin] - dp[fin])))
           if bool(fin.any()) and torch.equal(fin, torch.isfinite(d))
           else 0.0)
    check(bool(torch.equal(d, dp) and torch.equal(i, ip)
               and torch.equal(xyz, xp)),
          f"{tag} {name}: not bit-equal to the plain version (max|d-dp| "
          f"{err}, {int((i != ip).sum())} indices differ)")
    if not bool(mask.any()):
        check(bool(torch.isinf(d).all()),
              f"{tag} {name}: empty map gave a finite distance")
    done, total = knn_cuda.tiles_computed(q, ref, mask, k=k, max_sq_dist=cap)
    extra = dict(filled=float((i >= 0).float().mean()), tiles_computed=done,
                 tiles_total=total,
                 tiles_skipped_share=1.0 - done / max(total, 1))
    if q.shape[0] * int(mask.sum()) <= 2**30:  # informative only
        valid = ref[mask]
        kk = min(k, valid.shape[0])
        extra["cdist_topk_ms"] = call_ms(
            lambda: torch.topk(torch.cdist(q, valid), kk, largest=False),
            iters=5) if kk > 0 else None
    base = None if BASELINE is None else (
        lambda: BASELINE.knn_cuda.knn(q, ref, mask, k=k, max_sq_dist=cap))
    _timed("K1", tag, name, path,
           lambda: knn_cuda.knn(q, ref, mask, k=k, max_sq_dist=cap),
           lambda: knn_cuda.knn_plain(q, ref, mask, k=k, max_sq_dist=cap),
           _k1_bound(q, ref, mask, k, cap), base_fn=base,
           library_none_reason=K1_NO_LIBRARY, **extra)
    return err


def phase_k1(inp, dev):
    import torch
    from lis_slam_torch.utils import se3

    T = se3.pose_to_matrix(inp["pose"])
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    # the queries as scan_to_map hands them to K1: morton-sorted, then
    # moved to the map frame
    qc, _, mc, mc_mask = inp["corner"]
    qs, _, ms, ms_mask = inp["surf"]
    cw = se3.transform_points(T, _sorted(*inp["corner"][:2])).contiguous()
    sw = se3.transform_points(T, _sorted(*inp["surf"][:2])).contiguous()
    holes = ms_mask & (torch.rand(ms_mask.shape, generator=gen,
                                  device=dev) > 0.1)
    cases = [
        # path, name, query, map, mask, k, cap
        ("main", "corner Q1024 N16384 k8 cap4", cw, mc, mc_mask, 8, 4.0),
        ("main", "surf Q2048 N65536 k8 cap4", sw, ms, ms_mask, 8, 4.0),
        ("checks", "surf Q2000 N65536 k1 nocap holes",
         sw[:2000].contiguous(), ms, holes, 1, None),
        ("checks", "corner Q1000 N16384 k8 nocap", cw[:1000].contiguous(),
         mc, mc_mask, 8, None),
    ]
    return max(_check_knn("K1", name, q, ref, mask, k, cap, path)
               for path, name, q, ref, mask, k, cap in cases)


def _sorted(pts, mask):
    """A query cloud in scan_to_map's order (_morton_sort_queries)."""
    from lis_slam_torch.ops import scan_match

    return scan_match._morton_sort_queries(pts, mask, None)[0]


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


POSE_TRUE = (0.01, -0.02, 0.08, 0.5, -0.3, 0.05)
POSE_OFF = (0.002, -0.001, 0.004, 0.05, -0.03, 0.01)  # the GN guess's error


def _gn_case(mode, n_map, n_q, seed, cfg, dev, w_lo=0.5, w_hi=1.5):
    """One cloud of a well-conditioned world (_gn_world) seen from
    POSE_TRUE, with K1's candidates at the guess POSE_TRUE + POSE_OFF on
    the morton-ordered map: (pts, mask, cand, cand_ok, weight)."""
    import torch
    from lis_slam_torch.ops import knn_cuda, voxel
    from lis_slam_torch.utils import se3

    buf, buf_mask, world, rng = _gn_world(mode, n_map, dev, seed)
    leaf = (cfg.voxel.mapping_corner_leaf if mode == "corner"
            else cfg.voxel.mapping_surf_leaf)
    ref, _, ref_mask = voxel.voxel_merge_aged(  # morton-ordered map
        buf, buf_mask, torch.zeros_like(buf),
        torch.zeros(n_map, dtype=torch.int32, device=dev),
        torch.zeros_like(buf_mask), 0, 1, leaf, n_map)
    sel = world[rng.integers(0, len(world), n_q)]
    sel = sel + rng.normal(0, 0.02, sel.shape).astype(np.float32)
    pose_true = torch.tensor(POSE_TRUE, device=dev)
    T_inv = se3.transform_inverse(se3.pose_to_matrix(pose_true))
    q = se3.transform_points(T_inv, torch.from_numpy(sel).to(dev))
    q_mask = torch.from_numpy(rng.uniform(size=n_q) > 0.1).to(dev)
    w = torch.from_numpy(rng.uniform(w_lo, w_hi, n_q).astype(
        np.float32)).to(dev)
    T = se3.pose_to_matrix(pose_true + torch.tensor(POSE_OFF, device=dev))
    d, _, cand = knn_cuda.knn(se3.transform_points(T, q).contiguous(),
                              ref, ref_mask, k=cfg.matching.nn_cache_k,
                              max_sq_dist=4.0)
    return q.contiguous(), q_mask, cand, (d < 4.0).contiguous(), w


def _k2_rows(pose, cfg):
    """The (1, 2, 64) scalar rows K2 reads at `pose` (6,) on the card, as
    scan_to_map makes them: K3 with the solve skipped
    (gn_solve.scalar_rows)."""
    from lis_slam_torch.ops import gn_solve

    return gn_solve.scalar_rows(
        gn_solve.init_state(pose.reshape(1, 6).contiguous()), cfg.matching)


def _k2_args(rows, corner, surf, k):
    """gn_iteration_lanes' arguments at B = 1 for the clouds `corner` and
    `surf`, each (pts, mask, cand, cand_ok, weight or None)."""
    return (rows, *(t[None] for t in corner[:4]),
            *(t[None] for t in surf[:4]),
            *(None if c[4] is None else c[4][None] for c in (corner, surf)),
            k)


def _one_cloud(mode, cloud):
    """(corner, surf) for a launch over `cloud` alone: the other slot
    holds it with every query masked out."""
    import torch

    off = (cloud[0], torch.zeros_like(cloud[1]), *cloud[2:])
    return (cloud, off) if mode == "corner" else (off, cloud)


def _check_k2(tag, what, rows, corner, surf, k):
    """One K2 launch as the solvers on the card make it
    (gn_cuda.gn_iteration_lanes at B = 1: rows and sums in float64)
    against its plain version in float64: n_valid equal, H and g within
    GN_ATOL scaled. Returns (launch arguments, n_valid, the float32 plain
    version's n_valid, scaled error, the float32 plain version's scaled
    error against the float64 one)."""
    import torch
    from lis_slam_torch.ops import gn_cuda

    args = _k2_args(rows, corner, surf, k)
    hg = gn_cuda.gn_iteration_lanes(*args)[0]
    ref = gn_cuda.gn_iteration_lanes_plain(*args)[0]
    ref32 = gn_cuda.gn_iteration_lanes_plain(*args, torch.float32)[0]
    torch.cuda.synchronize()
    nv, nvd = int(hg[42]), int(ref[42])
    check(nv == nvd, f"{tag} {what}: n_valid {nv} vs the float64 plain "
          f"version's {nvd}")

    def err(a):
        return max(_scaled_err(a[:36], a[36:42], ref[:36], ref[36:42]))

    e = err(hg)
    check(e <= GN_ATOL, f"{tag} {what}: scaled error {e:.3g} against the "
          "float64 plain version")
    return args, nv, int(ref32[42]), e, err(ref32)


def _check_gn_pair(tag, label, path, corner, surf, cfg, pose, timed=True):
    """K2's one launch per GN iteration on the card (_check_k2, both
    clouds) at `pose`'s rows: n_valid and H, g against the float64 plain
    version, bit-equal from one launch to the next. Then its times
    (CASES["K2"]). Returns the scaled error."""
    import torch
    from lis_slam_torch.ops import gn_cuda

    k = cfg.matching.nn_cache_k
    args, nv, nv32, e, e32 = _check_k2(tag, label, _k2_rows(pose, cfg),
                                       corner, surf, k)
    hg = gn_cuda.gn_iteration_lanes(*args)
    hg2 = gn_cuda.gn_iteration_lanes(*args)
    torch.cuda.synchronize()
    check(bool(torch.equal(hg, hg2)),
          f"{tag} {label}: H or g not reproducible launch to launch")
    log(tag, f"{label} two clouds: n_valid {nv} (plain f32 {nv32}), scaled "
        f"err vs the float64 plain version {e:.3g} (plain f32 {e32:.3g}), "
        "bit-equal launch to launch")
    if not timed:
        return e
    base = None if BASELINE is None else (
        lambda: BASELINE.gn_cuda.gn_iteration_lanes(*args))
    name = (f"B1 corner Q{corner[0].shape[0]} + surf Q{surf[0].shape[0]} "
            f"k{k}")
    _timed("K2", tag, name, path, lambda: gn_cuda.gn_iteration_lanes(*args),
           lambda: gn_cuda.gn_iteration_lanes_plain(*args),
           _k2_bound([corner[:2] + corner[4:], surf[:2] + surf[4:]], k,
                     f64=True), base_fn=base,
           library_none_reason=K2_NO_LIBRARY, n_valid=float(nv))
    return e


def phase_k2(inp, cfg, dev):
    """K2 as the solvers on the card launch it (_check_k2) on the
    well-conditioned worlds at the front end's shapes, one cloud per
    launch and both in one launch; then on the circuit's real clouds
    (_check_gn_real)."""
    import torch

    k = cfg.matching.nn_cache_k
    worst = 0.0
    pose = torch.tensor(POSE_TRUE, device=dev) + torch.tensor(POSE_OFF,
                                                              device=dev)
    rows = _k2_rows(pose, cfg)
    clouds = {}
    for mode, n_map, n_q, seed in (("corner", 16384, 1024, 3),
                                   ("surf", 65536, 2048, 4)):
        clouds[mode] = c = _gn_case(mode, n_map, n_q, seed, cfg, dev)
        _a, nv, nv32, e, e32 = _check_k2("K2", mode, rows,
                                         *_one_cloud(mode, c), k)
        check(nv > n_q // 4, f"K2 {mode}: only {nv} valid rows")
        log("K2", f"{mode} Q{n_q} N{n_map} k{k}: ok, n_valid {nv} (plain "
            f"f32 {nv32}), scaled err vs the float64 plain version {e:.3g} "
            f"(plain f32 {e32:.3g})")
        worst = max(worst, e)
    worst = max(worst, _check_gn_pair("K2", "well-conditioned worlds",
                                      "checks", clouds["corner"],
                                      clouds["surf"], cfg, pose,
                                      timed=False))
    _check_gn_real("K2", "circuit", inp, cfg, "main")
    return worst


def _check_gn_real(tag, label, inp, cfg, path):
    """K2 on a path's real matched clouds against its map, near the true
    pose (_check_k2): each cloud alone and both in one launch, the
    float32 plain version's distance printed beside (surf rows whose five
    neighbours are nearly collinear have an ill-defined normal: float32
    rounding alone moves H by ~1e-3 scaled there); the two-cloud launch
    timed at the path's shapes."""
    import torch
    from lis_slam_torch.ops import knn_cuda
    from lis_slam_torch.utils import se3

    k = cfg.matching.nn_cache_k
    dev = inp["pose"].device
    pose = inp["pose"] + torch.tensor(POSE_OFF, device=dev)
    T = se3.pose_to_matrix(pose)
    rows = _k2_rows(pose, cfg)
    clouds = {}
    for mode in ("corner", "surf"):
        q, q_mask, ref, ref_mask = inp[mode]
        d, _, cand = knn_cuda.knn(se3.transform_points(T, q).contiguous(),
                                  ref, ref_mask, k=k, max_sq_dist=4.0)
        # the front end passes no weights: the kernel reads them as ones
        clouds[mode] = (q.contiguous(), q_mask.contiguous(), cand,
                        (d < 4.0).contiguous(), None)
        _a, nv, nv32, e, e32 = _check_k2(tag, f"{label} {mode}", rows,
                                         *_one_cloud(mode, clouds[mode]), k)
        check(nv > 0, f"{tag} {label} {mode}: no valid rows")
        log(tag, f"{label} {mode} Q{q.shape[0]} N{ref.shape[0]}: n_valid "
            f"{nv} (plain f32 {nv32}), scaled err vs the float64 plain "
            f"version {e:.3g} (plain f32 {e32:.3g})")
    _check_gn_pair(tag, label, path, clouds["corner"], clouds["surf"], cfg,
                   pose)


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
            f"K2 launches {counts[backend][1]}, K3 launches "
            f"{counts[backend][2]}")
        check(ate < ATE_MAX, f"main {backend}: ATE {ate} >= {ATE_MAX}")
        check(rpe_t < RPE_T_MAX, f"main {backend}: RPE-t {rpe_t}")
        runs[backend] = res
    log("main", "peak device memory over both runs "
        f"{torch.cuda.max_memory_allocated()} bytes")
    check(counts["xla"][0] > 0 and counts["pallas"][0] > 0,
          "K1 was not launched on the main path")
    check(counts["xla"][1] == 0 and counts["pallas"][1] > 0,
          "K2 launches do not follow gn_backend")
    check(counts["xla"][2] == 0 and counts["pallas"][2] > 0,
          "K3 launches do not follow gn_backend")

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

    # K3 at B = 1 as scan_to_map launches it: every solve of scans 5-7
    # under "pallas" from the state after scans 0-4, against its plain
    # version
    state = odometry.init_state(cp, dev)
    for s in scans[:5]:
        state, _ = odometry.odom_step(state, s, cp)

    def steps():
        nonlocal state
        for s in scans[5:8]:
            state, _ = odometry.odom_step(state, s, cp)

    calls = _record_k3(steps)
    check(len(calls) > 0, "main pallas: no K3 call recorded")
    k3 = _check_k3(calls, cfg, "main")
    return ({"main_xla": counts["xla"], "main_pallas": counts["pallas"]},
            runs["pallas"].poses, k3)


def _pkg_mod(pkg, name):
    """Module `name` (e.g. "ops.gn_solve") of this checkout's package, or
    of the package named `pkg` (--baseline's)."""
    import importlib

    return importlib.import_module(f"{pkg or 'lis_slam_torch'}.{name}")


def _launches(pkg=None):
    """(K1, K2, K3) launch counts."""
    return (_pkg_mod(pkg, "ops.knn_cuda").knn.launches,
            _pkg_mod(pkg, "ops.gn_cuda").gn_iteration_vec.launches,
            _pkg_mod(pkg, "ops.gn_solve").solve.launches)


def _zero_launches(pkg=None):
    _pkg_mod(pkg, "ops.knn_cuda").knn.launches = 0
    _pkg_mod(pkg, "ops.gn_cuda").gn_iteration_vec.launches = 0
    _pkg_mod(pkg, "ops.gn_solve").solve.launches = 0


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
    for mode, (q, q_mask, ref, ref_mask) in (("corner", inp["corner"]),
                                             ("surf", inp["surf"])):
        _check_knn("lio K1", f"{mode} Q{q.shape[0]} N{ref.shape[0]} k{k} "
                   "cap4", se3.transform_points(T, _sorted(q, q_mask))
                   .contiguous(), ref, ref_mask, k, 4.0, "lio")
    _check_gn_real("lio K2", "LIO map", inp, cfg, "lio")
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


def _render_plaza(cfg, dev, distorted=False, extra=SLAM_EXTRA):
    """The plaza lap of bench.py:145-201 on the card: SLAM_LAP scans, then
    `extra` along the start of the lap on a second noise render (its first
    SLAM_EXTRA scans are the same for any `extra`; SLAM_LAP of them make
    the endurance phase's second full lap); each compacted as the bench's
    loader does, with its labels. With
    `distorted`, each sweep moves from gt[i] to gt[i + 1] over its 0.1 s,
    and scan k's IMU rows of that motion (imu_rows: 24 samples over 0.11
    s, at k * 0.1 s) come pre-rotated by extrinsic_rot^T. Returns (seq,
    gt poses, IMU rows or None)."""
    import torch
    from lis_slam_torch.io import synthetic, synthetic_torch
    from lis_slam_torch.pipeline import driver

    n = SLAM_LAP
    world = synthetic_torch.to_device_world(synthetic_torch.plaza_world(),
                                            dev)
    gt = synthetic.circular_trajectory(
        n + 1, radius=10.0, speed=2.0 * np.pi * 10.0 / (n * 0.1))
    R_ext = np.asarray(cfg.imu.extrinsic_rot, np.float64)
    seq, imu = [], []
    for lap_seed, count in ((9, n), (11, extra)):
        gen = torch.Generator(device=dev)
        gen.manual_seed(lap_seed)
        for i in range(count):
            nxt = torch.as_tensor(gt[i + 1]) if distorted else None
            p, lab, v = synthetic_torch.render_scan_device(
                world, torch.as_tensor(gt[i]), gen, next_pose6=nxt)
            if distorted:
                g, a, t = synthetic_torch.imu_rows(gt[i], gt[i + 1])
                imu.append((t + len(seq) * 0.1,
                            (g @ R_ext).astype(np.float32),
                            (a @ R_ext).astype(np.float32)))
            seq.append((driver.compact_scan(p, v, cfg),
                        driver.compact_labels(p, v, lab, cfg)))
    gt_seq = np.concatenate([gt[:n], gt[:extra]])
    return seq, gt_seq, (imu if distorted else None)


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


def _check_slam_kernels(system, cfg, dev, path="slam"):
    """K1 and K2 at the back end's shapes, against their plain versions:
    K1 bit-equal against the submap-sized targets (geometric surf N
    131072, with labels the semantic registration's 3 x 32768 = 98304) at
    Q 8192; with labels K1 at k=1 (dynamic removal) on the local map with
    holes and on an empty map, without them (no refinement, so no
    dynamic removal) K1 at the front end's k and cap on its surf map; K2
    at the registration's corner 4096 + surf 8192 (the refinement's too),
    weights in [0.5, 2] with labels, unit without. Returns the worst
    error of each kernel (K1 distance, K2 scaled)."""
    import torch
    from lis_slam_torch.ops import voxel
    from lis_slam_torch.utils import se3

    subs = system.collector.submaps
    check(len(subs) >= 3, f"{path}: {len(subs)} submaps")
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
    # registration runs scan_to_map: its queries come morton-sorted
    qr = se3.transform_points(T, _sorted(q, _qm)).contiguous()
    k = cfg.matching.nn_cache_k
    labels = prev.class_xyz is not None  # submaps with class clouds
    cases = [
        (f"geo registration Q{qw.shape[0]} N{prev.surf_xyz.shape[0]} k{k} "
         "cap4", qr, prev.surf_xyz, prev.surf_mask, k, 4.0),
    ]
    if labels:
        t_sem = torch.cat([prev.class_xyz[c] for c in (0, 1, 2)])
        t_sem_m = torch.cat([prev.class_mask[c] for c in (0, 1, 2)])
        cases += [
            (f"dynamic removal Q{qw.shape[0]} N{sem.surf_pts.shape[0]} k1 "
             "nocap holes", qw, sem.surf_pts, holes, 1, None),
            (f"dynamic removal Q{qw.shape[0]} empty map k1 nocap", qw,
             sem.surf_pts, torch.zeros_like(holes), 1, None),
            (f"sem registration Q{qw.shape[0]} N{t_sem.shape[0]} k{k} cap4",
             qr, t_sem.contiguous(), t_sem_m.contiguous(), k, 4.0)]
    else:
        st = system.state
        cases.append((f"front-end surf map Q{qw.shape[0]} "
                      f"N{st.map_surf.shape[0]} k{k} cap4", qr, st.map_surf,
                      st.map_surf_mask, k, 4.0))
    worst_k1 = max(_check_knn(f"{path} K1", name, qq, ref, mask, kk, cap,
                              path)
                   for name, qq, ref, mask, kk, cap in cases)

    # K2 with non-unit weights in [0.5, 2] at the refinement's capacities
    # (matched corner 4096, surf 8192), both clouds in one launch
    pose = torch.tensor(POSE_TRUE, device=dev) + torch.tensor(POSE_OFF,
                                                              device=dev)
    w = (0.5, 2.0) if labels else (1.0, 1.0)
    corner = _gn_case("corner", 16384, cfg.submap.matched_corner_capacity,
                      12, cfg, dev, *w)
    surf = _gn_case("surf", 65536, cfg.submap.matched_surf_capacity, 11, cfg,
                    dev, *w)
    worst_k2 = _check_gn_pair(
        f"{path} K2", "weighted refine shapes" if labels
        else "registration shapes", path, corner, surf, cfg, pose)
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
    "_lio_pre": "IMU chain", "_lio_post": "IMU chain",
}


class _SyncCount:
    """Counts the synchronizing CUDA calls made inside the block (sync
    debug mode "warn": each warns once), by stage: a call is charged to
    the innermost SYNC_STAGES function on its Python stack."""

    def __init__(self):
        self.by_stage: dict[str, int] = {}

    def __enter__(self):
        import torch

        def show(message, category, filename, lineno, file=None, line=None):
            if "synchronizing" not in str(message):
                return
            f, stage = sys._getframe(1), "other"
            while f is not None:
                if f.f_code.co_name in SYNC_STAGES:
                    stage = SYNC_STAGES[f.f_code.co_name]
                    break
                f = f.f_back
            self.by_stage[stage] = self.by_stage.get(stage, 0) + 1

        self._w = warnings.catch_warnings()
        self._w.__enter__()
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc):
        import torch

        torch.cuda.set_sync_debug_mode("default")
        self._w.__exit__(*exc)

    def ordered(self) -> dict[str, int]:
        return dict(sorted(self.by_stage.items(), key=lambda kv: -kv[1]))


def _slam_syncs(cfg, seq, dev, hook=_slam_drift_hook, scan_kw=None):
    """Host syncs of a SemanticSlam run over `seq` (scan 0 through
    flush_pipeline, with `hook` and scan i's process_scan keywords
    scan_kw(i) (default its timestamp), as the timed run), by stage."""
    from lis_slam_torch.pipeline import slam

    system = slam.SemanticSlam(cfg, pose_hook=hook, device=dev)
    with _SyncCount() as counter:
        for i, (scan, labels) in enumerate(seq):
            kw = dict(timestamp=i * 0.1) if scan_kw is None else scan_kw(i)
            system.process_scan(scan, gt_labels=labels, **kw)
        system.flush_pipeline()
    return counter.ordered(), system


def _slam_cfg():
    """The slam phase's configuration: default SlamConfig, the bench's
    65536-row scan buffer, the fused GN iteration (K2)."""
    import dataclasses

    from lis_slam_torch.config import SensorConfig, SlamConfig

    base = SlamConfig().replace(sensor=SensorConfig(max_raw_points=65536))
    return base.replace(matching=dataclasses.replace(base.matching,
                                                     gn_backend="pallas"))


def phase_slam(dev, out_dir):
    """SemanticSlam at full width on the plaza lap with injected drift;
    accuracy against the JAX package's bar, then the kernels at the back
    end's shapes and the LM on the card vs the host."""
    import torch
    from lis_slam_torch.pipeline import trajectory

    cfg = _slam_cfg()
    t = time.perf_counter()
    seq, gt, _ = _render_plaza(cfg, dev)
    torch.cuda.synchronize()
    log("slam", f"rendered and compacted {len(seq)} plaza scans on the card "
        f"in {time.perf_counter() - t:.2f} s; points/scan "
        f"{int(seq[0][0].valid.sum())} of {cfg.sensor.max_raw_points}")

    _slam_run(cfg, seq[:SLAM_WARMUP], dev, "slam")  # warm-up
    system, res, sps, counts, peak = _slam_run(cfg, seq, dev, "slam")
    n = len(seq)
    gt_rel = trajectory.relative_to_first(gt)
    ate = trajectory.ate_rmse(res.poses, gt_rel, align=True)
    raw = trajectory.ate_rmse(res.raw_poses, gt_rel, align=True)
    rpe_t, rpe_r = trajectory.rpe(res.poses, gt_rel)
    stages = {k: round(v["total_ms"], 3)
              for k, v in system.timer.report().items()}
    bar = 1.5 * JAX_SLAM_ATE + 0.02
    log("slam", f"{sps:.3f} scans/s ({n - 1} timed scans through "
        f"flush_pipeline, {(n - 1) / sps:.3f} s); ATE aligned corrected "
        f"{ate:.4f} m, "
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
                   "scans_per_s": sps, "stages_total_ms": stages,
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
    return {"slam": counts}, err, (seq, gt)


def _plaza_scan(dev, horizon: int, seed: int):
    """One HDL-64 sweep of the plaza lap (pose 7 of the slam phase's lap),
    rendered on the card with `horizon` columns: (points, labels, valid)."""
    import torch
    from lis_slam_torch.io import synthetic, synthetic_torch

    world = synthetic_torch.to_device_world(synthetic_torch.plaza_world(),
                                            dev)
    gt = synthetic.circular_trajectory(
        SLAM_LAP + 1, radius=10.0,
        speed=2.0 * np.pi * 10.0 / (SLAM_LAP * 0.1))
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return synthetic_torch.render_scan_device(
        world, torch.as_tensor(gt[7]), gen, horizon=horizon)


def phase_semantic(dev, out_dir):
    """RangeNet on the card: the in-repo slim checkpoint labelling one
    plaza scan (64 x 1800) per raw point against ground truth, and the
    keyframe path's labelling of the front end's projection of it; then
    the full-size darknet53 (default SemanticConfig, weights drawn from a
    seeded generator) at 64 x 2048 x 5, batch 1, bf16: device and call ms
    per inference, parameters, FLOPs, TFLOP/s against the bf16 peak,
    argmax agreement with the float32 forward of the same weights.
    Returns the full-size weight tree."""
    import dataclasses

    import torch
    from lis_slam_torch.config import SemanticConfig, SensorConfig, SlamConfig
    from lis_slam_torch.models import rangenet
    from lis_slam_torch.ops import pretreatment, projection
    from lis_slam_torch.semantic import inference, weights

    # 1. the slim checkpoint, per raw point
    cfg = SlamConfig().replace(sensor=SensorConfig(max_raw_points=64 * 1800))
    pts, lab_gt, valid = _plaza_scan(dev, 1800, 13)
    slim = inference.SemanticInference(cfg, device=dev)
    lab, sem = slim(pts, valid)
    m = valid & (lab > 0)
    acc = float((lab[m] == lab_gt[m].to(lab.dtype)).float().mean())
    n_lab = int(m.sum())
    with torch.no_grad():
        slim_dev, _ = device_ms(lambda: slim(pts, valid), iters=10)
        slim_call = call_ms(lambda: slim(pts, valid), iters=10)
    log("semantic", f"slim checkpoint (64 x 1800, bf16, "
        f"{slim.cfg.semantic.enc_widths} encoder): per-point label accuracy "
        f"{acc:.4f} on {n_lab} labelled points (limit > {SEM_ACC_MIN}); "
        f"infer_scan_labels device {slim_dev:.4f} ms (profiler), call "
        f"{slim_call:.4f} ms")
    check(n_lab > 10000, f"semantic: only {n_lab} points labelled")
    check(acc > SEM_ACC_MIN, f"semantic: label accuracy {acc}")
    check(tuple(sem.labels.shape) == (64, 1800), "semantic: image shape")
    # the keyframe path: RangeNet on the front end's projection
    pre = pretreatment.pretreat(pts, valid, cfg.sensor)
    _img, ext = projection.project_and_extract(
        pre.points[:, :3], pre.points[:, 3], pre.ring, pre.rel_time,
        pre.valid, cfg.sensor)

    def winners():
        return inference.infer_winner_labels(slim.model, ext, pts.shape[0],
                                             slim.cfg)

    lab_w = winners()
    win = ext.src[ext.mask].long()
    same = bool((lab_w[win] == lab[win]).all())
    with torch.no_grad():
        kf_dev, _ = device_ms(winners, iters=10)
        kf_call = call_ms(winners, iters=10)
    log("semantic", f"keyframe path (infer_winner_labels on the front "
        f"end's projection): device {kf_dev:.4f} ms (profiler), call "
        f"{kf_call:.4f} ms; labels of the {win.numel()} pixel winners "
        f"equal to infer_scan_labels': {same}")
    check(same, "semantic: winner labels differ from infer_scan_labels")

    # 2. the full-size darknet53 on a plaza scan projected to 64 x 2048
    full = SemanticConfig(enabled=True)
    t = time.perf_counter()
    tree = rangenet.init_params(full, torch.Generator().manual_seed(0))
    n_params = sum(a.size for a in weights._flatten(tree).values())
    init_s = time.perf_counter() - t
    with torch.device("meta"):
        flops = rangenet.forward_flops(
            rangenet.create_model(full),
            torch.empty(1, full.model_input_h, full.model_input_w,
                        full.model_input_c))
    scfg = SensorConfig(horizon_scan=full.model_input_w, downsample_rate=1,
                        max_raw_points=full.model_input_h
                        * full.model_input_w)
    pts, _lab, valid = _plaza_scan(dev, full.model_input_w, 17)
    pre = pretreatment.pretreat(pts, valid, scfg)
    img, _ = projection.project_and_extract(
        pre.points[:, :3], pre.points[:, 3], pre.ring, pre.rel_time,
        pre.valid, scfg, want_image=True)
    x = rangenet.build_input_image(img.rng, img.xyz, img.intensity, img.mask,
                                   full)[None].contiguous()
    net = inference.load_model(tree, full, dev)
    net32 = inference.load_model(tree, dataclasses.replace(full, fp16=False),
                                 dev)
    runs = []
    with torch.no_grad():
        for _ in range(2):
            d, by_kernel = device_ms(lambda: net(x), iters=10)
            runs.append((d, call_ms(lambda: net(x), iters=10), by_kernel))
        y16, y32 = net(x)[0], net32(x)[0]
        d32, _ = device_ms(lambda: net32(x), iters=5)
    torch.cuda.synchronize()
    mask = img.mask
    agree = float((y16.argmax(-1) == y32.argmax(-1))[mask].float().mean())
    gap = float((y16 - y32).abs()[mask].max())
    dev_ms = float(np.mean([r[0] for r in runs]))
    summary = dict(device_ms=dev_ms, device_ms_runs=[r[0] for r in runs],
                   call_ms=float(np.mean([r[1] for r in runs])),
                   tflops=flops / dev_ms / 1e9,
                   peak_share=flops / dev_ms / 1e9 * 1e12 / PEAK_BF16_FLOPS,
                   top_kernels_ms=dict(sorted(runs[0][2].items(),
                                              key=lambda kv: -kv[1])[:6]))
    log("semantic", f"darknet53 64 x {full.model_input_w} x "
        f"{full.model_input_c} batch 1 bf16: device {dev_ms:.4f} ms per "
        f"inference (profiler; runs "
        f"{', '.join(f'{r[0]:.4f}' for r in runs)}), call "
        f"{summary['call_ms']:.4f} ms (events), {summary['tflops']:.2f} "
        f"TFLOP/s = {summary['peak_share']:.4f} of the 989 TFLOP/s dense "
        "bf16 peak (H100 SXM, 700 W)")
    log("semantic", f"darknet53: {n_params} parameters with batch "
        f"statistics (drawn in {init_s:.2f} s), {flops} FLOPs per inference "
        f"(convolutions, 2 per multiply-add); float32 forward {d32:.4f} ms; "
        f"argmax bf16 vs float32 agrees on {agree:.4f} of {int(mask.sum())} "
        f"masked pixels, max logit gap {gap:.4f} (max |logit| "
        f"{float(y32.abs().max()):.4f})")
    with open(os.path.join(out_dir, "semantic.json"), "w") as f:
        json.dump({"slim_accuracy": acc, "slim_device_ms": slim_dev,
                   "slim_call_ms": slim_call,
                   "keyframe_path_device_ms": kf_dev,
                   "keyframe_path_call_ms": kf_call, "params": n_params,
                   "flops": flops, "fp32_device_ms": d32,
                   "bf16_fp32_argmax_agree": agree, "logit_gap": gap,
                   "darknet53": summary}, f, indent=1)
    check(n_params == DARKNET_PARAMS,
          f"darknet53: {n_params} parameters, not {DARKNET_PARAMS}")
    check(tuple(y16.shape) == (64, full.model_input_w, full.num_classes)
          and bool(torch.isfinite(y16).all()), "darknet53: logits")
    check(agree > 0.95, f"darknet53: bf16 vs float32 argmax {agree}")
    del net, net32
    return tree


def _slam_run(cfg, seq, dev, tag, labels=True, hook=_slam_drift_hook,
              imu=None, gps=None, build_map=False, **system_kw):
    """SemanticSlam over seq ((scan, labels) pairs) with `hook`: scan 0,
    the timed rest through flush_pipeline, then finish(build_map). With
    `labels` the ground-truth labels are fed, else the system's RangeNet
    labels the keyframes. imu: [(time, gyro, accel)] per scan, scan 0
    without a timestamp (the bench's lio_full_slam run); gps: gt poses for
    a fix every GPS_EVERY scans (+ seeded 0.05 m noise, covariance 0.01,
    timestamped). system_kw go to SemanticSlam. Returns (system, result,
    scans/s, K1/K2/K3 launches, peak bytes)."""
    import torch
    from lis_slam_torch.pipeline import slam

    _zero_launches()
    torch.cuda.reset_peak_memory_stats()
    system = slam.SemanticSlam(cfg, pose_hook=hook, device=dev, **system_kw)

    def step(i):
        kw = dict(timestamp=i * 0.1)
        if imu is not None:
            kw = dict(timestamp=i * 0.1 if i else None, imu_time=imu[i][0],
                      imu_gyro=imu[i][1], imu_accel=imu[i][2])
        system.process_scan(seq[i][0], gt_labels=seq[i][1] if labels
                            else None, **kw)
        if gps is not None and i % GPS_EVERY == 0:
            noise = np.random.default_rng(i).normal(0, 0.05, 3)
            system.add_gps(gps[i, 3:] + noise, np.full(3, 0.01),
                           timestamp=i * 0.1)

    step(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(1, len(seq)):
        step(i)
    system.flush_pipeline()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    res = system.finish(build_map=build_map)
    check(res.poses.shape == (len(seq), 6)
          and bool(np.isfinite(res.poses).all()),
          f"{tag}: corrected poses not finite (n, 6)")
    return (system, res, (len(seq) - 1) / wall, _launches(),
            torch.cuda.max_memory_allocated())


def phase_slam_infer(seq, gt, darknet, dev, out_dir):
    """The slam phase's lap with labels inferred on every keyframe: the
    in-repo checkpoint (cfg.semantic.enabled, no gt_labels), accuracy
    against the JAX package's run of the same mode; then the first
    SLAM_INFER_FULL_SCANS scans with the full-size darknet53 weights as
    rangenet_params (random weights: scans/s only)."""
    import dataclasses

    from lis_slam_torch.config import SemanticConfig, SensorConfig, SlamConfig
    from lis_slam_torch.pipeline import trajectory

    base = SlamConfig().replace(sensor=SensorConfig(max_raw_points=65536),
                                semantic=SemanticConfig(enabled=True))
    cfg = base.replace(matching=dataclasses.replace(base.matching,
                                                    gn_backend="pallas"))
    _slam_run(cfg, seq[:SLAM_WARMUP], dev, "slam_infer", labels=False)
    n = len(seq)
    system, res, sps, counts, peak = _slam_run(cfg, seq, dev, "slam_infer",
                                               labels=False)
    check(system.model is not None, "slam_infer: no RangeNet model")
    gt_rel = trajectory.relative_to_first(gt)
    ate = trajectory.ate_rmse(res.poses, gt_rel, align=True)
    raw = trajectory.ate_rmse(res.raw_poses, gt_rel, align=True)
    rpe_t, rpe_r = trajectory.rpe(res.poses, gt_rel)
    stages = {k: round(v["total_ms"], 3)
              for k, v in system.timer.report().items()}
    jx = JAX_SLAM_INFER
    bar = 1.5 * jx["ate_corrected_m"] + 0.02
    log("slam_infer", f"{sps:.3f} scans/s ({n - 1} timed scans through "
        f"flush_pipeline, labels inferred on every keyframe by the "
        f"{system._infer_cfg.semantic.enc_widths} checkpoint); ATE aligned "
        f"corrected {ate:.4f} m, raw {raw:.4f} m (JAX CPU same mode "
        f"{jx['ate_corrected_m']:.4f} / {jx['ate_raw_m']:.4f}, limit "
        f"{bar:.4f}); RPE-t {rpe_t:.4f} m, RPE-r {rpe_r:.4f} deg; submaps "
        f"{res.n_submaps} (JAX {jx['n_submaps']}), loop factors "
        f"{res.n_loops} (JAX {jx['loop_factors']}), keyframes "
        f"{len(system.keyframes)} (JAX {jx['keyframes']}); K1 launches "
        f"{counts[0]}, K2 launches {counts[1]}; peak device memory {peak} "
        "bytes")
    log("slam_infer", "stage totals ms: " + json.dumps(stages))
    check(res.n_loops >= 1, "slam_infer: no loop factor")
    check(ate < raw, f"slam_infer: corrected ATE {ate} >= raw {raw}")
    check(ate <= bar, f"slam_infer: corrected ATE {ate} > {bar}")
    check(abs(res.n_submaps - jx["n_submaps"]) <= 1,
          f"slam_infer: {res.n_submaps} submaps, JAX {jx['n_submaps']}")
    check(counts[0] > 0 and counts[1] > 0, f"slam_infer: launches {counts}")
    out = {"ate_corrected_m": ate, "ate_raw_m": raw, "rpe_t_m": rpe_t,
           "rpe_r_deg": rpe_r, "scans_per_s": sps, "stages_total_ms": stages,
           "n_submaps": res.n_submaps, "loop_factors": res.n_loops,
           "keyframes": len(system.keyframes), "peak_bytes": peak,
           "jax_cpu": jx, "poses": res.poses.tolist(),
           "raw_poses": res.raw_poses.tolist()}
    del system

    # cfg.semantic is the default SemanticConfig: the released darknet53
    n_full = SLAM_INFER_FULL_SCANS
    system, res, sps_full, counts_full, peak_full = _slam_run(
        cfg, seq[:n_full], dev, "slam_infer", labels=False,
        rangenet_params=darknet)
    log("slam_infer", f"full-size darknet53 weights (random, seeded) as "
        f"rangenet_params: {sps_full:.3f} scans/s over {n_full - 1} timed "
        f"scans, {len(system.keyframes)} keyframes, finite poses; K1 "
        f"launches {counts_full[0]}, K2 launches {counts_full[1]}; peak "
        f"device memory {peak_full} bytes")
    out.update(darknet53_scans_per_s=sps_full,
               darknet53_keyframes=len(system.keyframes),
               darknet53_peak_bytes=peak_full)
    with open(os.path.join(out_dir, "slam_infer.json"), "w") as f:
        json.dump(out, f)
    return {"slam_infer": counts, "slam_infer_darknet53": counts_full}


# ---------------------------------------------------------------------------
# lio_slam: SemanticSlam with the IMU chain, GPS, debug dump, CG graph solve
# ---------------------------------------------------------------------------

# the JAX package's runs of the lio_slam phase's sequences on a CPU
# (scripts/lio_full_slam_accuracy_bars.py: numpy renderer, gn_backend
# "xla", aligned ATE): "lio" is part (a), "none" part (b), "dist_*" part
# (c). The card's renderer draws other noise over the same geometry: (a)
# may reach 1.5 x its corrected ATE + 0.02 m; its resets must equal and
# its submaps lie within 1.
JAX_LIO_SLAM = {
    "lio": {"ate_corrected_m": 0.17735777675786218,
            "ate_raw_m": 0.2966845250783563, "imu_resets": 0,
            "n_submaps": 10, "loop_factors": 6, "keyframes": 47},
    "none": {"ate_corrected_m": 0.01609776971642015,
             "ate_raw_m": 0.01566679058953778, "imu_resets": 0,
             "n_submaps": 10, "loop_factors": 0, "keyframes": 47},
    "dist_lio": {"ate_corrected_m": 0.05668758434439395,
                 "ate_raw_m": 0.05757739798068766, "imu_resets": 0,
                 "n_submaps": 10, "loop_factors": 3, "keyframes": 47},
    "dist_none": {"ate_corrected_m": 0.12595770152171096,
                  "ate_raw_m": 0.27519694100060965, "imu_resets": 0,
                  "n_submaps": 10, "loop_factors": 6, "keyframes": 47},
}
GPS_EVERY = 5  # a fix every 5th scan (tests/test_loop_graph.py:562)
GPS_DRIFT = 0.002  # rad of yaw per scan (:551-556)
GPS_RATIO = 0.7  # ATE with GPS < 0.7 x without (:572-575)
CG_AGREE_M = 5e-3  # CG vs dense, 64-node drifted loop with a GPS prior
CG_SIZES = (512, 1024)


def _bench_imu(cfg, speed):
    """The JAX bench's lio_full_slam IMU (bench.py:432-443): 12 constant
    samples 0.01 s apart, yaw rate w = v / 10, specific force (0, v w, g),
    pre-rotated by extrinsic_rot^T. Returns (time, gyro, accel)."""
    omega = speed / 10.0
    R_ext = np.asarray(cfg.imu.extrinsic_rot, np.float64)
    g = np.tile(R_ext.T @ [0.0, 0.0, omega], (12, 1)).astype(np.float32)
    a = np.tile(R_ext.T @ [0.0, speed * omega, cfg.imu.gravity],
                (12, 1)).astype(np.float32)
    return np.arange(12, dtype=np.float32) * 0.01, g, a


def _drifted_square(gb, n):
    """tests/test_loop_graph.py:281-304's square loop (biased odometry, one
    exact loop closure) with a GPS prior at node n / 2. Returns (gt,
    est) lists of (4, 4)."""
    import torch
    from lis_slam_torch.utils import se3, se3_np

    gt = []
    for k in range(n):
        side, frac = 4 * k // n, (k % (n // 4)) / (n // 4)
        t = {0: (10 * frac, 0), 1: (10, 10 * frac),
             2: (10 - 10 * frac, 10), 3: (0, 10 - 10 * frac)}[side]
        gt.append(se3_np.pose_to_matrix(np.array(
            [0, 0, np.pi / 2 * (side % 4), t[0], t[1], 0])).astype(
                np.float32))
    bias = se3.se3_exp(torch.tensor([0.02, 0.01, 0, 0, 0, 0.002])).numpy()
    est = [gt[0]]
    gb.add_node(gt[0])
    for k in range(1, n):
        z = (np.linalg.inv(gt[k - 1]) @ gt[k]) @ bias
        est.append(est[-1] @ z)
        gb.add_node(est[-1])
        gb.add_odom_edge(k - 1, k, z)
    gb.add_loop_edge(n - 1, 0, np.linalg.inv(gt[-1]) @ gt[0], scale=100.0)
    gb.add_gps_prior(n // 2, gt[n // 2], np.full(3, 0.01))
    return gt, est


def _cg_phase(dev):
    """optimize_cg against the dense LM on a 64-node drifted loop with a
    GPS prior (CG on the card, dense on the host), then the CG solve's
    ms on the host and on the card at CG_SIZES nodes (one
    GraphBuilder.optimize after a warm-up, readback included), and the
    end node's pull at the first size."""
    import dataclasses

    import torch
    from lis_slam_torch.config import GraphConfig
    from lis_slam_torch.graph import pose_graph

    cg = dataclasses.replace(GraphConfig(), solver="cg")

    def builder(n, device, cfg=cg):
        gb = pose_graph.GraphBuilder(cfg, max_nodes=n, max_edges=2 * n,
                                     max_priors=8, device=device)
        return (gb, *_drifted_square(gb, n))

    card = builder(64, dev)[0].optimize()
    dense = builder(64, "cpu", dataclasses.replace(cg, solver="dense"))[0]
    err = float(np.abs(card - dense.optimize()).max())
    out = {"agree_64_max_abs": err}
    for n in CG_SIZES:
        for name, device in (("host", torch.device("cpu")), ("card", dev)):
            gb, gt, est = builder(n, device)
            gb.optimize()  # warm-up
            t = time.perf_counter()
            gb.nodes = [e.copy() for e in est]
            opt = gb.optimize()
            out[f"{name}_ms_{n}"] = (time.perf_counter() - t) * 1e3
            if n == CG_SIZES[0]:
                before = float(np.linalg.norm(est[-1][:3, 3] - gt[-1][:3, 3]))
                after = float(np.linalg.norm(opt[-1][:3, 3] - gt[-1][:3, 3]))
                anchor = float(np.abs(opt[0] - gt[0]).max())
                out[f"pull_{name}"] = (before, after, anchor)
    log("lio_slam", f"(f) optimize_cg (20 sweeps x 96 CG steps, float32): "
        f"64-node drifted loop + GPS prior, card CG vs host dense max|dT| "
        f"{err:.3g} (limit {CG_AGREE_M}); "
        + ", ".join(f"{n} nodes host {out[f'host_ms_{n}']:.3f} ms, card "
                    f"{out[f'card_ms_{n}']:.3f} ms" for n in CG_SIZES)
        + "; end-node pull at "
        f"{CG_SIZES[0]}: {out['pull_card'][0]:.3f} -> "
        f"{out['pull_card'][1]:.3f} m (card), node 0 off its anchor by "
        f"{out['pull_card'][2]:.2g}")
    check(err <= CG_AGREE_M, f"lio_slam: CG {err} from the dense solve")
    for name in ("host", "card"):
        before, after, anchor = out[f"pull_{name}"]
        check(after < 0.5 * before and anchor <= 1e-3,
              f"lio_slam: CG on the {name} pulled {before} -> {after} m, "
              f"anchor off by {anchor}")
    return out


def phase_lio_slam(seq, gt, dev, out_dir):
    """SemanticSlam with cfg.imu.use_imu on the slam phase's lap: (a) the
    JAX bench's lio_full_slam mode, held to the JAX package's run; (b) the
    same scans without the IMU; (c) motion-distorted sweeps, fused and
    LiDAR-only; (d) predict_imu_rate; (e) GPS fixes on a drifting lap
    without loop closure, with the debug dump; (f) the CG graph solve.
    K1 and K2 against their plain versions at the path's shapes."""
    import dataclasses

    import torch
    from lis_slam_torch.config import SensorConfig, SlamConfig
    from lis_slam_torch.io import kitti, synthetic
    from lis_slam_torch.pipeline import driver, odometry, slam, trajectory
    from lis_slam_torch.utils import se3
    from lis_slam_torch.viz import debug

    base = SlamConfig().replace(sensor=SensorConfig(max_raw_points=65536))
    cfg0 = base.replace(matching=dataclasses.replace(base.matching,
                                                     gn_backend="pallas"))
    cfg = cfg0.replace(imu=dataclasses.replace(cfg0.imu, use_imu=True))
    n = len(seq)
    speed = 2.0 * np.pi * 10.0 / (SLAM_LAP * 0.1)
    it0, g0, a0 = _bench_imu(cfg, speed)
    imu = [(it0 + i * 0.1, g0, a0) for i in range(n)]
    gt_rel = trajectory.relative_to_first(gt)
    out = {}

    def imu_kw(i):
        return dict(timestamp=None if i == 0 else i * 0.1,
                    imu_time=imu[i][0], imu_gyro=imu[i][1],
                    imu_accel=imu[i][2])

    # (a) the bench's lio_full_slam mode, after a warm-up run
    _slam_run(cfg, seq[:SLAM_WARMUP], dev, "lio_slam", hook=None, imu=imu)
    system, res, sps, counts, peak = _slam_run(cfg, seq, dev, "lio_slam",
                                               hook=None, imu=imu)
    jx = JAX_LIO_SLAM["lio"]
    ate = trajectory.ate_rmse(res.poses, gt_rel, align=True)
    raw = trajectory.ate_rmse(res.raw_poses, gt_rel, align=True)
    rpe_t, rpe_r = trajectory.rpe(res.poses, gt_rel)
    chain = system.timer.stats["imu_chain"]
    imu_ms = chain.total_s / n * 1e3
    stages = {k: round(v["total_ms"], 3)
              for k, v in system.timer.report().items()}
    bar = 1.5 * jx["ate_corrected_m"] + 0.02
    log("lio_slam", f"(a) lio_full_slam: {sps:.3f} scans/s ({n - 1} timed "
        f"scans through flush_pipeline); ATE aligned corrected {ate:.4f} m, "
        f"raw {raw:.4f} m (JAX CPU {jx['ate_corrected_m']:.4f} / "
        f"{jx['ate_raw_m']:.4f}, limit {bar:.4f}); RPE-t {rpe_t:.4f} m, "
        f"RPE-r {rpe_r:.4f} deg; IMU resets {system.n_imu_resets} (JAX "
        f"{jx['imu_resets']}); submaps {res.n_submaps} (JAX "
        f"{jx['n_submaps']}), loop factors {res.n_loops} (JAX "
        f"{jx['loop_factors']}), keyframes {len(system.keyframes)} (JAX "
        f"{jx['keyframes']}); host IMU chain {imu_ms:.3f} ms/scan "
        f"({chain.count} calls); K1 launches {counts[0]}, K2 launches "
        f"{counts[1]}; peak device memory {peak} bytes")
    log("lio_slam", "stage totals ms: " + json.dumps(stages))
    out["a"] = dict(scans_per_s=sps, ate_corrected_m=ate, ate_raw_m=raw,
                    rpe_t_m=rpe_t, rpe_r_deg=rpe_r,
                    imu_resets=system.n_imu_resets,
                    n_submaps=res.n_submaps, loop_factors=res.n_loops,
                    keyframes=len(system.keyframes), imu_chain_ms=imu_ms,
                    peak_bytes=peak, stages_total_ms=stages,
                    poses=res.poses.tolist())
    check(ate <= bar, f"lio_slam (a): corrected ATE {ate} > {bar}")
    check(system.n_imu_resets == jx["imu_resets"],
          f"lio_slam (a): {system.n_imu_resets} IMU resets, JAX "
          f"{jx['imu_resets']}")
    check(abs(res.n_submaps - jx["n_submaps"]) <= 1,
          f"lio_slam (a): {res.n_submaps} submaps, JAX {jx['n_submaps']}")
    check(res.n_loops >= 1, "lio_slam (a): no loop factor")
    check(counts[0] > 0 and counts[1] > 0, f"lio_slam (a): launches {counts}")
    syncs, s2 = _slam_syncs(cfg, seq, dev, hook=None, scan_kw=imu_kw)
    n_kf = len(s2.keyframes)
    log("lio_slam", f"(a) host syncs over a second, untimed run of the "
        f"{n} scans through flush_pipeline, by stage: {json.dumps(syncs)}; "
        f"front end {syncs.get('front end', 0) / n:.1f} and IMU chain "
        f"{syncs.get('IMU chain', 0) / n:.1f} per scan, the rest "
        f"{(sum(syncs.values()) - syncs.get('front end', 0) - syncs.get('IMU chain', 0)) / max(n_kf, 1):.1f}"
        f" per keyframe ({n_kf})")
    out["a"]["syncs_by_stage"] = syncs
    del s2

    # (d) predict_imu_rate on the last window of (a)
    win = imu[-1]
    rate = system.predict_imu_rate(*win)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(20):
        system.predict_imu_rate(*win)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t) / 20 * 1e3
    ev_ms = call_ms(lambda: system.predict_imu_rate(*win))
    rate_h = rate.cpu().numpy()
    start = float(np.linalg.norm(rate_h[0, 3:]
                                 - system.fstate.imu.p.numpy()))
    # ground truth at the sample times: linear between the last scan's
    # pose and the next one on the lap (constant speed)
    full = synthetic.circular_trajectory(SLAM_LAP + 1, radius=10.0,
                                         speed=speed)
    nxt = trajectory.relative_to_first(np.stack(
        [gt[0], full[(n - 1) % SLAM_LAP + 1]]))[1]
    frac = np.clip((win[0] - (n - 1) * 0.1) / 0.1, 0.0, 1.5)[:len(rate_h)]
    gt_pos = (gt_rel[-1][None, 3:] * (1 - frac[:, None])
              + nxt[None, 3:] * frac[:, None])
    inc_err = float(np.linalg.norm((rate_h[:, 3:] - rate_h[0, 3:])
                                   - (gt_pos - gt_pos[0]), axis=1).max())
    log("lio_slam", f"(d) predict_imu_rate: ({rate.shape[0]}, 6) on "
        f"{rate.device}, call {ev_ms:.4f} ms (CUDA events), host "
        f"{host_ms:.4f} ms; first pose {start:.2e} m from the nav state's p "
        f"(limit 1e-3); increments vs ground truth max {inc_err:.4f} m "
        f"over {float(np.linalg.norm(gt_pos[-1] - gt_pos[0])):.4f} m")
    out["d"] = dict(call_ms=ev_ms, host_ms=host_ms, start_m=start,
                    increment_err_m=inc_err)
    check(rate.shape == (len(win[0]), 6) and rate.device.type == "cuda"
          and bool(torch.isfinite(rate).all()),
          f"lio_slam (d): {tuple(rate.shape)} on {rate.device}")
    check(start <= 1e-3, f"lio_slam (d): stream starts {start} m off")

    # K1 / K2 at this path's shapes: the last scan's gyro-deskewed matched
    # clouds against the odometry map, then the back end's shapes
    sin = seq[-1][0]
    wl = slam.ImuWindow(*driver.pad_imu_window(cfg, *win), float(win[0][0]))
    sin, _chain = slam._lio_pre(system.fstate, sin, wl, cfg)
    qc, qc_mask, qs, qs_mask = odometry._matched_clouds(
        odometry.preprocess(sin, cfg), cfg)
    st = system.fstate.odom
    pose = torch.as_tensor(res.raw_poses[-1], dtype=torch.float32, device=dev)
    inp = dict(corner=(qc, qc_mask, st.map_corner, st.map_corner_mask),
               surf=(qs, qs_mask, st.map_surf, st.map_surf_mask), pose=pose)
    T = se3.pose_to_matrix(pose)
    k = cfg.matching.nn_cache_k
    errs_k1 = [_check_knn("lio_slam K1", f"{mode} Q{q.shape[0]} "
                          f"N{ref.shape[0]} k{k} cap4",
                          se3.transform_points(T, _sorted(q, q_mask))
                          .contiguous(), ref, ref_mask, k, 4.0, "lio_slam")
               for mode, (q, q_mask, ref, ref_mask) in (
                   ("corner", inp["corner"]), ("surf", inp["surf"]))]
    _check_gn_real("lio_slam K2", "LIO-SLAM map", inp, cfg, "lio_slam")
    k1_back, k2_back = _check_slam_kernels(system, cfg, dev, "lio_slam")
    del inp, sin, system

    # (b) the same scans without the IMU (a contrast, no check)
    _s, res_b, sps_b, _c, _p = _slam_run(
        cfg0, seq, dev, "lio_slam", hook=None,
        debug_dir=os.path.join(out_dir, "debug_b"))
    ate_b = trajectory.ate_rmse(res_b.poses, gt_rel, align=True)
    raw_b = trajectory.ate_rmse(res_b.raw_poses, gt_rel, align=True)
    pgms = sorted(f for f in os.listdir(os.path.join(out_dir, "debug_b"))
                  if f.endswith(".pgm"))
    shapes = {debug.read_pgm(os.path.join(out_dir, "debug_b", f)).shape
              for f in pgms}
    log("lio_slam", f"(b) no IMU, same scans: ATE aligned corrected "
        f"{ate_b:.4f} m, raw {raw_b:.4f} m (JAX CPU "
        f"{JAX_LIO_SLAM['none']['ate_corrected_m']:.4f} / "
        f"{JAX_LIO_SLAM['none']['ate_raw_m']:.4f}), loop factors "
        f"{res_b.n_loops}, submaps {res_b.n_submaps}, {sps_b:.3f} scans/s "
        f"with the debug dump on: {len(pgms)} descriptor images {shapes} "
        f"for {len(_s.keyframes)} keyframes")
    out["b"] = dict(ate_corrected_m=ate_b, ate_raw_m=raw_b,
                    loop_factors=res_b.n_loops, n_submaps=res_b.n_submaps)
    check(len(pgms) == len(_s.keyframes) > 0 and len(shapes) == 1,
          f"lio_slam (b): {len(pgms)} descriptor images, "
          f"{len(_s.keyframes)} keyframes, shapes {shapes}")
    del _s

    # (c) motion-distorted sweeps: fused and LiDAR-only
    t = time.perf_counter()
    dseq, _gt, dimu = _render_plaza(cfg, dev, distorted=True)
    torch.cuda.synchronize()
    render_s = time.perf_counter() - t
    c_out = {}
    for name, c, w in (("fused", cfg, dimu), ("lidar_only", cfg0, None)):
        s_c, r_c, _sps, _c, _p = _slam_run(c, dseq, dev, "lio_slam",
                                           hook=None, imu=w)
        c_out[name] = dict(
            ate_corrected_m=trajectory.ate_rmse(r_c.poses, gt_rel,
                                                align=True),
            ate_raw_m=trajectory.ate_rmse(r_c.raw_poses, gt_rel, align=True),
            imu_resets=s_c.n_imu_resets, loop_factors=r_c.n_loops,
            n_submaps=r_c.n_submaps)
        del s_c
    del dseq
    log("lio_slam", f"(c) motion-distorted sweeps (rendered in "
        f"{render_s:.2f} s): fused ATE aligned corrected "
        f"{c_out['fused']['ate_corrected_m']:.4f} m, raw "
        f"{c_out['fused']['ate_raw_m']:.4f}, resets "
        f"{c_out['fused']['imu_resets']} (JAX CPU "
        f"{JAX_LIO_SLAM['dist_lio']['ate_corrected_m']:.4f} / "
        f"{JAX_LIO_SLAM['dist_lio']['ate_raw_m']:.4f}); LiDAR-only corrected "
        f"{c_out['lidar_only']['ate_corrected_m']:.4f} m, raw "
        f"{c_out['lidar_only']['ate_raw_m']:.4f} (JAX CPU "
        f"{JAX_LIO_SLAM['dist_none']['ate_corrected_m']:.4f} / "
        f"{JAX_LIO_SLAM['dist_none']['ate_raw_m']:.4f})")
    out["c"] = c_out
    check(c_out["fused"]["imu_resets"] == 0,
          f"lio_slam (c): {c_out['fused']['imu_resets']} IMU resets")

    # (e) GPS on a drifting lap without loop closure, debug dump on
    ce = cfg0.replace(
        loop=dataclasses.replace(cfg0.loop, enabled=False),
        graph=dataclasses.replace(cfg0.graph, odom_rot_sigma=1e-2,
                                  odom_trans_sigma=1e-1))

    def drift(pose6, idx):
        from lis_slam_torch.utils import se3_np

        c_, s_ = np.cos(GPS_DRIFT * idx), np.sin(GPS_DRIFT * idx)
        Td = np.eye(4)
        Td[:2, :2] = [[c_, -s_], [s_, c_]]
        return se3_np.matrix_to_pose(Td @ se3_np.pose_to_matrix(pose6))

    ddir = os.path.join(out_dir, "debug_gps")
    _s, r_plain, *_ = _slam_run(ce, seq, dev, "lio_slam", hook=drift)
    del _s
    s_g, r_gps, *_ = _slam_run(ce, seq, dev, "lio_slam", hook=drift,
                               gps=gt_rel, debug_dir=ddir, build_map=True)
    ate_plain = trajectory.ate_rmse(r_plain.poses, gt_rel, align=False)
    ate_gps = trajectory.ate_rmse(r_gps.poses, gt_rel, align=False)
    with open(os.path.join(ddir, "loop_edges.json")) as f:
        edges = json.load(f)
    with open(os.path.join(ddir, "loop_markers.ply")) as f:
        ply = f.read()
    cloud = kitti.read_pcd(os.path.join(ddir, "global_map.pcd"))
    n_priors = len(s_g.graph.priors) - 1
    log("lio_slam", f"(e) GPS every {GPS_EVERY} scans, yaw drift "
        f"{GPS_DRIFT} rad/scan, no loop closure: ATE (unaligned) with GPS "
        f"{ate_gps:.4f} m, without {ate_plain:.4f} m (ratio "
        f"{ate_gps / ate_plain:.3f}, limit {GPS_RATIO}); {n_priors} GPS "
        f"priors, {s_g._gps_dropped} dropped; debug dump: "
        f"{len(edges)} loop edges, marker PLY {len(ply)} bytes, global map "
        f"{cloud.shape}")
    out["e"] = dict(ate_gps_m=ate_gps, ate_plain_m=ate_plain,
                    gps_priors=n_priors, gps_dropped=s_g._gps_dropped)
    check(ate_gps < GPS_RATIO * ate_plain,
          f"lio_slam (e): GPS ATE {ate_gps} vs {ate_plain}")
    check(ply.startswith("ply") and "element edge" in ply
          and edges == [] and cloud.shape == (len(r_gps.global_map), 4),
          "lio_slam (e): debug files do not read back")
    del s_g

    # (f) the CG graph solve
    out["f"] = _cg_phase(dev)
    with open(os.path.join(out_dir, "lio_slam.json"), "w") as f:
        json.dump(out, f)
    return {"lio_slam": counts}, (max(max(errs_k1), k1_back), k2_back)


# ---------------------------------------------------------------------------
# cli, checkpoint, ndt, train: the KITTI-replay CLI, resume, NDT, training
# ---------------------------------------------------------------------------

# scripts/cli_accuracy_bars.py: the JAX package's SemanticSlam on the plaza
# lap as the CLI sees it (numpy renderer, kitti preset, 150000-row buffer,
# range gate, no labels, no drift; CPU, gn_backend "xla")
JAX_CLI = {"ate_corrected_m": 0.021926960587686672,
           "ate_raw_m": 0.01566679058953778, "n_submaps": 10,
           "loop_factors": 0, "keyframes": 47}
CKPT_AT = 70  # the checkpoint phase saves after this many scans
CKPT_RAW_ATOL = 1e-4  # m / rad, tests/test_io_runtime.py:185-190
CKPT_CORRECTED_ATOL = 5e-3
NDT_ATOL = 1e-4  # card vs host transform
TRAIN_STEPS = 5
TRAIN_BATCH = 2
TRAIN_LR = 3e-3  # tests/test_rangenet_train.py:67


def phase_cli(card, dev, out_dir):
    """The port's KITTI-replay CLI in-process (run_kitti.main) on the plaza
    lap rendered at the kitti preset's full HDL-64 width (64 x 1800) and
    written as a KITTI sequence; then K1/K2 at the CLI's back-end shapes.
    Returns the path's K1/K2/K3 launches and the kernels' worst errors."""
    import torch
    from lis_slam_torch import run_kitti
    from lis_slam_torch.config import PRESETS
    from lis_slam_torch.io import kitti, synthetic, synthetic_torch
    from lis_slam_torch.pipeline import trajectory
    from lis_slam_torch.runtime import native

    n = SLAM_LAP
    world = synthetic_torch.to_device_world(synthetic_torch.plaza_world(),
                                            dev)
    gt = synthetic.circular_trajectory(
        n + 1, radius=10.0, speed=2.0 * np.pi * 10.0 / (n * 0.1))
    t = time.perf_counter()
    clouds = []
    for lap_seed, count in ((9, n), (11, SLAM_EXTRA)):
        gen = torch.Generator(device=dev)
        gen.manual_seed(lap_seed)
        for i in range(count):
            p, _lab, v = synthetic_torch.render_scan_device(
                world, torch.as_tensor(gt[i]), gen)
            clouds.append(p[v].cpu().numpy())
    gt_seq = np.concatenate([gt[:n], gt[:SLAM_EXTRA]])
    root = os.path.join(ROOT, "smoke_out", "kitti")  # ~250 MB, removed below
    shutil.rmtree(root, ignore_errors=True)
    run_kitti.write_sequence(root, "00", clouds, gt_seq)
    log("cli", f"rendered {len(clouds)} plaza scans (64 x 1800) on the card "
        f"and wrote them as KITTI sequence 00 in "
        f"{time.perf_counter() - t:.2f} s; points/scan "
        f"{int(np.mean([len(c) for c in clouds]))}")
    pred = os.path.join(out_dir, "cli_pred.txt")
    pcd = os.path.join(out_dir, "cli_map.pcd")
    check(native.available(), "cli: the native loader did not build")

    _zero_launches()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    system, res, timer = run_kitti.main([
        "--root", root, "--sequence", "00", "--out", pred, "--save-map", pcd,
        "--gn-backend", "pallas"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    counts, peak = _launches(), torch.cuda.max_memory_allocated()
    cfg = system.cfg
    check(cfg.sensor.max_raw_points == PRESETS["kitti"]().sensor.max_raw_points
          == 150_000 and system.device.type == "cuda",
          "cli: not the kitti preset on the card")
    poses = np.loadtxt(pred)
    cloud = kitti.read_pcd(pcd)
    gt_rel = run_kitti.ground_truth6(root, "00", len(res.poses))
    shutil.rmtree(root)
    ate = trajectory.ate_rmse(res.poses, gt_rel, align=True)
    raw = trajectory.ate_rmse(res.raw_poses, gt_rel, align=True)
    bar = 1.5 * JAX_CLI["ate_corrected_m"] + 0.02
    scan = timer.stats["scan"]
    sps = scan.count / scan.total_s
    log("cli", f"run_kitti.main: {len(poses)} poses written, map.pcd "
        f"{cloud.shape}; {sps:.3f} scans/s over the scan loop (native "
        f"loader, pad_scan, pinned copy, process_scan), {len(clouds) / wall:.3f}"
        f" scans/s with set-up, finish and the map; ATE aligned corrected "
        f"{ate:.4f} m, raw {raw:.4f} m (JAX CPU corrected "
        f"{JAX_CLI['ate_corrected_m']:.4f}, limit {bar:.4f}); submaps "
        f"{res.n_submaps}, loop factors {res.n_loops}, keyframes "
        f"{len(system.keyframes)} (JAX {JAX_CLI['n_submaps']}, "
        f"{JAX_CLI['loop_factors']}, {JAX_CLI['keyframes']}); K1 launches "
        f"{counts[0]}, K2 launches {counts[1]}; peak device memory {peak} "
        f"bytes; on {card}")
    with open(os.path.join(out_dir, "cli.json"), "w") as f:
        json.dump({"ate_corrected_m": ate, "ate_raw_m": raw, "jax": JAX_CLI,
                   "scans_per_s_loop": sps, "scans_per_s_wall":
                   len(clouds) / wall, "n_submaps": res.n_submaps,
                   "loop_factors": res.n_loops,
                   "keyframes": len(system.keyframes), "peak_bytes": peak,
                   "launches": list(counts), "map_points": len(cloud)}, f)
    check(poses.shape == (len(clouds), 12), f"cli: pred.txt {poses.shape}")
    check(res.global_map is not None
          and cloud.shape == (len(res.global_map), 4),
          f"cli: map.pcd {cloud.shape}")
    check(ate <= bar, f"cli: corrected ATE {ate} > {bar}")
    check(counts[0] > 0 and counts[1] > 0, f"cli: launches {counts}")
    err = _check_slam_kernels(system, cfg, dev, path="cli")
    return {"cli": counts}, err


def phase_checkpoint(seq, gt, dev, out_dir):
    """Resume across released keyframes: the slam phase's run (gt labels,
    drift hook) uninterrupted, and saved after CKPT_AT scans
    (runtime/checkpoint.save_slam), loaded into a fresh SemanticSlam and
    continued. Returns the uninterrupted system (its submaps feed the ndt
    phase)."""
    import torch
    from lis_slam_torch.pipeline import slam
    from lis_slam_torch.runtime import checkpoint

    cfg = _slam_cfg()
    full, r_full, *_ = _slam_run(cfg, seq, dev, "checkpoint")

    def feed(system, lo, hi):
        for i in range(lo, hi):
            system.process_scan(seq[i][0], gt_labels=seq[i][1],
                                timestamp=i * 0.1)

    first = slam.SemanticSlam(cfg, pose_hook=_slam_drift_hook, device=dev)
    feed(first, 0, CKPT_AT)
    path = os.path.join(out_dir, "slam_ckpt.npz")
    torch.cuda.synchronize()
    t = time.perf_counter()
    checkpoint.save_slam(path, first)
    save_ms = (time.perf_counter() - t) * 1e3
    released = sum(kf.released for kf in first.keyframes)
    n_kf = len(first.keyframes)
    del first
    resumed = slam.SemanticSlam(cfg, pose_hook=_slam_drift_hook, device=dev)
    t = time.perf_counter()
    checkpoint.load_slam(path, resumed)
    torch.cuda.synchronize()
    load_ms = (time.perf_counter() - t) * 1e3
    on_card = all(kf.surf_xyz.device.type == "cuda"
                  for kf in resumed.keyframes if not kf.released)
    still = sum(kf.released for kf in resumed.keyframes)
    feed(resumed, CKPT_AT, len(seq))
    r_res = resumed.finish()
    d_raw = float(np.abs(r_res.raw_poses - r_full.raw_poses).max())
    d_cor = float(np.abs(r_res.poses - r_full.poses).max())
    size = os.path.getsize(path)
    os.remove(path)
    log("checkpoint", f"saved after scan {CKPT_AT}: {size} bytes, save "
        f"{save_ms:.1f} ms (flush_pipeline included), load {load_ms:.1f} ms; "
        f"{released} of {n_kf} keyframes released at the save, {still} "
        f"released after the load; resumed vs uninterrupted over "
        f"{len(seq)} scans: raw poses max |diff| {d_raw:.3g} (limit "
        f"{CKPT_RAW_ATOL}), corrected {d_cor:.3g} (limit "
        f"{CKPT_CORRECTED_ATOL}); submaps {r_res.n_submaps} vs "
        f"{r_full.n_submaps}, loop factors {r_res.n_loops} vs "
        f"{r_full.n_loops}")
    with open(os.path.join(out_dir, "checkpoint.json"), "w") as f:
        json.dump({"bytes": size, "save_ms": save_ms, "load_ms": load_ms,
                   "released_at_save": released, "keyframes_at_save": n_kf,
                   "raw_max_diff": d_raw, "corrected_max_diff": d_cor,
                   "n_submaps": [r_res.n_submaps, r_full.n_submaps],
                   "loop_factors": [r_res.n_loops, r_full.n_loops]}, f)
    check(released > 0 and still == released,
          f"checkpoint: released keyframes {released} at the save, {still} "
          "after the load")
    check(on_card, "checkpoint: restored clouds are not on the card")
    check(d_raw <= CKPT_RAW_ATOL, f"checkpoint: raw poses differ by {d_raw}")
    check(d_cor <= CKPT_CORRECTED_ATOL,
          f"checkpoint: corrected poses differ by {d_cor}")
    check(r_res.n_submaps == r_full.n_submaps
          and r_res.n_loops == r_full.n_loops,
          "checkpoint: submaps or loop factors differ")
    return full


ENDURANCE_LAPS = 10  # bench.py:276 (BENCH_ENDURANCE_SCANS 1000)
ENDURANCE_RESUME_AT = 500  # the resume run's save: end of lap 5 (render B)
ENDURANCE_MEM_FACTOR = 1.5  # device memory growth, lap 2 -> 10, vs reckoned
CENTROID_LEAF = 0.4  # the submap surf leaf
CENTROID_RTOL = 2e-6  # card vs host, of |coordinate| (test_torch_downsample)
MASK_RATIO = 0.5  # random_downsample_mask's keep ratio on the card
MASK_TARGET = 20000  # fixed_count_downsample_mask's target on the card
# scripts/endurance_accuracy_bars.py: the JAX package on the CPU,
# gn_backend "xla", 10 laps, 1111 s (timeout 5400 python
# scripts/endurance_accuracy_bars.py, 2026-10-17)
JAX_ENDURANCE = {"ate_corrected_m": 0.021829740481900617,
                 "ate_raw_m": 1.216783662650576,
                 "lap_ate_m": [0.02912605649972124, 0.018534379952923688,
                               0.022634113813255176, 0.019799363108653305,
                               0.019781855879348595, 0.02337745126096615,
                               0.019731727749246152, 0.020335388681874993,
                               0.020723189997488935, 0.022339665038040083],
                 "loop_factors": 98, "n_submaps": 67, "keyframes": 334,
                 "keyframes_released": 326, "graph_nodes": 67,
                 "graph_edges": 164}


def _endurance_bytes(cfg):
    """Device bytes that the endurance run adds, reckoned from config.py's
    capacities, each tensor rounded up to the caching allocator's 512-byte
    blocks: a closed submap (corner, surf and class clouds: xyz float32,
    masks bool, class weights float32), a keyframe's retained fields
    once its clouds are released (its selected descriptor (rings x
    sectors) and 360 x 4 signature in the loop detector; its poses live on
    the host), a keyframe's clouds while they are held (class clouds,
    front-end corner and surf), and a graph node (0: the graph and its LM
    live on the host; the CG path's tensors are transient)."""
    def t(n, itemsize=4):
        return -(-n * itemsize // 512) * 512

    sc, lc, fc = cfg.submap, cfg.loop, cfg.feature
    qk = sc.keyframe_class_capacity
    return dict(
        submap=(t(3 * sc.corner_capacity) + t(sc.corner_capacity, 1)
                + t(3 * sc.surf_capacity) + t(sc.surf_capacity, 1)
                + t(15 * sc.class_capacity) + t(5 * sc.class_capacity, 1)
                + t(5 * sc.class_capacity)),
        kf_retained=t(lc.rings * lc.sectors) + t(360 * 4),
        kf_clouds=(t(15 * qk) + t(5 * qk, 1) + t(5 * qk)
                   + t(3 * fc.max_corner_points) + t(fc.max_corner_points, 1)
                   + t(3 * fc.max_surf_points) + t(fc.max_surf_points, 1)),
        node=0)


def _endurance_mark(system):
    """The back end's counts at a lap boundary."""
    import torch

    kfs = system.keyframes
    return dict(mem=torch.cuda.memory_allocated(),
                submaps=len(system.collector.submaps), keyframes=len(kfs),
                released=sum(kf.released for kf in kfs),
                nodes=len(system.graph.nodes), edges=len(system.graph.edges),
                loop_factors=system._n_loop_factors)


def _endurance_downsample(seq, dev):
    """The centroid voxel downsample on one compacted plaza scan (65536
    rows), twice on the card (bit-equal) and on the host (within
    CENTROID_RTOL); the two random masks' kept share on the card within 5
    binomial sigmas; ms a call (CUDA events) and its device time."""
    import torch
    from lis_slam_torch.mapping import submap as sm
    from lis_slam_torch.ops import voxel

    scan = seq[0][0]
    pts, valid = scan.points[:, :3].contiguous(), scan.valid
    cap = pts.shape[0]

    def run(p, v):
        return voxel.voxel_downsample(p, v, CENTROID_LEAF, cap, centroid=True)

    a, b = run(pts, valid), run(pts, valid)
    same = all(torch.equal(x, y) for x, y in zip(a, b))
    h = run(pts.cpu(), valid.cpu())
    n_card, n_host = int(a[2]), int(h[2])
    masks_eq = torch.equal(a[1].cpu(), h[1])
    ref = h[0].numpy()
    err = float(np.max(np.abs(a[0].cpu().numpy() - ref)
                       / np.maximum(np.abs(ref), 1.0)))
    ms = call_ms(lambda: run(pts, valid), iters=10)
    dms, by_name = device_ms(lambda: run(pts, valid), iters=10)
    top = dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:4])
    n = int(valid.sum())
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    shares = {}
    for name, fn, p in (
            ("random", lambda: sm.random_downsample_mask(valid, MASK_RATIO,
                                                         gen), MASK_RATIO),
            ("fixed_count", lambda: sm.fixed_count_downsample_mask(
                valid, MASK_TARGET, gen), min(1.0, MASK_TARGET / n))):
        m = fn()
        kept = int(m.sum())
        sigma = float(np.sqrt(n * p * (1 - p)))
        shares[name] = dict(kept=kept, n=n, p=p, sigma=sigma,
                            subset=not bool((m & ~valid).any()),
                            ms=call_ms(fn, iters=10))
    log("endurance", f"centroid voxel_downsample (leaf {CENTROID_LEAF}, "
        f"{n} of {cap} rows): {n_card} voxels on the card, {n_host} on the "
        f"host; two card runs bit-equal {same}; masks equal {masks_eq}; "
        f"card vs host max rel err {err:.3g} (limit {CENTROID_RTOL}); "
        f"{ms:.4f} ms a call (CUDA events), {dms:.4f} ms of device time "
        f"(profiler; largest: {json.dumps(top)}); masks: "
        + json.dumps(shares))
    check(same, "endurance: the centroid downsample differs run to run")
    check(n_card == n_host and masks_eq,
          f"endurance: centroid voxels {n_card} on the card vs {n_host}")
    check(err <= CENTROID_RTOL, f"endurance: centroid card vs host {err}")
    for name, sh in shares.items():
        check(sh["subset"], f"endurance: {name} mask keeps invalid rows")
        check(abs(sh["kept"] - sh["n"] * sh["p"]) <= 5 * sh["sigma"],
              f"endurance: {name} mask kept {sh['kept']} of {sh['n']}")
    return dict(centroid_voxels=n_card, centroid_bit_equal=same,
                centroid_rel_err=err, centroid_ms=ms, centroid_device_ms=dms,
                masks=shares)


def phase_endurance(seq, gt, dev, out_dir):
    """SemanticSlam over ENDURANCE_LAPS plaza laps (bench.py:274-400),
    uninterrupted and resumed from a checkpoint after
    ENDURANCE_RESUME_AT scans; then K1/K2 at the final system's shapes.
    `seq`, `gt`: the slam phase's render (checked against the longer
    one). Returns ({"endurance": K1/K2/K3 launches}, (K1 err, K2 err))."""
    import resource

    import torch
    from lis_slam_torch.pipeline import slam, trajectory
    from lis_slam_torch.runtime import checkpoint

    cfg = _slam_cfg()
    t = time.perf_counter()
    two, gt2, _ = _render_plaza(cfg, dev, extra=SLAM_LAP)
    torch.cuda.synchronize()
    render_s = time.perf_counter() - t
    check(all(torch.equal(a[0].points, b[0].points)
              and np.array_equal(a[1], b[1]) for a, b in zip(seq, two)),
          "endurance: the longer render's first scans are not the slam "
          "phase's")
    laps, n = ENDURANCE_LAPS, SLAM_LAP
    lap_a, lap_b = two[:n], two[n:2 * n]
    run = [(lap_a if (k // n) % 2 == 0 else lap_b)[k % n]
           for k in range(laps * n)]
    gt_tiled = np.tile(trajectory.relative_to_first(gt2[:n]), (laps, 1))
    down = _endurance_downsample(two, dev)

    def feed(system, lo, hi, marks=None, counter=None, cum=None):
        """Scans lo..hi-1; at each lap's end, the back end's counts into
        `marks`, or the syncs `counter` holds so far into `cum`."""
        for k in range(lo, hi):
            system.process_scan(run[k][0], gt_labels=run[k][1],
                                timestamp=k * 0.1)
            if (k + 1) % n == 0 and marks is not None:
                marks.append(_endurance_mark(system))
            if (k + 1) % n == 0 and counter is not None:
                cum.append(sum(counter.by_stage.values()))

    _slam_run(cfg, run[:SLAM_WARMUP], dev, "endurance")  # warm-up
    _zero_launches()
    torch.cuda.reset_peak_memory_stats()
    system = slam.SemanticSlam(cfg, pose_hook=_slam_drift_hook, device=dev)
    marks, walls = [], []
    torch.cuda.synchronize()
    t0 = t_lap = time.perf_counter()
    for lap in range(laps):
        feed(system, lap * n, (lap + 1) * n, marks)
        now = time.perf_counter()
        walls.append(now - t_lap)
        t_lap = now
    t_fl = time.perf_counter()
    system.flush_pipeline()
    torch.cuda.synchronize()
    flush_s = time.perf_counter() - t_fl
    wall = time.perf_counter() - t0
    counts = _launches()
    peak = torch.cuda.max_memory_allocated()
    res = system.finish()
    final = _endurance_mark(system)
    sps = laps * n / wall
    lap_sps = n / float(np.median(walls))
    ate = trajectory.ate_rmse(res.poses, gt_tiled, align=True)
    raw = trajectory.ate_rmse(res.raw_poses, gt_tiled, align=True)
    e = res.poses[:, 3:6].astype(np.float64)
    R, tr = trajectory.align_umeyama(e, gt_tiled[:, 3:6])
    lap_ate = np.sqrt(np.mean(np.sum((e @ R.T + tr - gt_tiled[:, 3:6]) ** 2,
                                     axis=1).reshape(laps, n), axis=1))
    # loop factors landed while each lap ran (the last lap's with the flush
    # and finish)
    lf = [m["loop_factors"] for m in marks[:-1]] + [res.n_loops]
    lap_loops = np.diff([0] + lf).tolist()
    n_keep = cfg.submap.release_after_submaps
    subs = system.collector.submaps
    held = sum(len(s.kf_indices) for s in subs[-n_keep:]) + len(
        system.collector._cur_kfs)
    g = system.graph
    padded = g._bucket(len(g.nodes), g.max_nodes)
    route = ("cg" if cfg.graph.solver == "cg" or (
        cfg.graph.solver == "auto" and padded > cfg.graph.dense_max_nodes)
        else "dense LM")
    solves = system.timer.stats["graph_optimize"].count if (
        "graph_optimize" in system.timer.stats) else 0
    stages = {k: round(v["total_ms"], 3)
              for k, v in system.timer.report().items()}
    host_rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    per = _endurance_bytes(cfg)
    m2, m10 = marks[1], marks[-1]
    d_sub = m10["submaps"] - m2["submaps"]
    d_kf = m10["keyframes"] - m2["keyframes"]
    d_held = ((m10["keyframes"] - m10["released"])
              - (m2["keyframes"] - m2["released"]))
    d_nodes = m10["nodes"] - m2["nodes"]
    reckoned = (d_sub * per["submap"] + d_kf * per["kf_retained"]
                + d_held * per["kf_clouds"] + d_nodes * per["node"])
    grown = m10["mem"] - m2["mem"]
    bar = 1.5 * JAX_ENDURANCE["ate_corrected_m"] + 0.02
    log("endurance", f"rendered the second full lap with the first on the "
        f"card in {render_s:.2f} s; {laps} laps x {n} scans: "
        f"{sps:.3f} scans/s through flush_pipeline ({wall:.3f} s), median "
        f"lap {lap_sps:.3f} scans/s, flush tail {flush_s:.3f} s; lap walls "
        f"s {[round(w, 3) for w in walls]}")
    log("endurance", f"ATE aligned corrected {ate:.4f} m, raw {raw:.4f} m "
        f"(JAX CPU corrected {JAX_ENDURANCE['ate_corrected_m']:.4f}, raw "
        f"{JAX_ENDURANCE['ate_raw_m']:.4f}; limit {bar:.4f}); per-lap ATE "
        f"{[round(float(x), 4) for x in lap_ate]} (JAX "
        f"{[round(x, 4) for x in JAX_ENDURANCE['lap_ate_m']]}); loop "
        f"factors {res.n_loops} (JAX {JAX_ENDURANCE['loop_factors']}), per "
        f"lap {lap_loops}; submaps {res.n_submaps} (JAX "
        f"{JAX_ENDURANCE['n_submaps']}); keyframes {final['keyframes']} "
        f"(JAX {JAX_ENDURANCE['keyframes']}), released "
        f"{final['released']} (JAX {JAX_ENDURANCE['keyframes_released']}), "
        f"held {held}")
    log("endurance", f"pose graph {final['nodes']} nodes (padded "
        f"{padded}, dense_max_nodes {cfg.graph.dense_max_nodes}: {route}), "
        f"{final['edges']} edges (JAX {JAX_ENDURANCE['graph_nodes']} / "
        f"{JAX_ENDURANCE['graph_edges']}), {solves} solves; K1 launches "
        f"{counts[0]}, K2 launches {counts[1]}")
    log("endurance", f"device memory allocated after each lap (bytes): "
        f"{[m['mem'] for m in marks]}; peak {peak}; lap 2 -> {laps}: "
        f"+{grown} bytes for {d_sub} submaps, {d_kf} keyframes ({d_held:+d} "
        f"holding clouds), {d_nodes} nodes; reckoned {reckoned} bytes "
        f"({json.dumps(per)}), limit {ENDURANCE_MEM_FACTOR} x; peak host "
        f"RSS of the process {host_rss} bytes")
    log("endurance", "stage totals ms: " + json.dumps(stages))

    # the resume: scans 0..RESUME_AT-1, saved, loaded into a fresh system,
    # the rest; host syncs per lap counted meanwhile (untimed)
    first = slam.SemanticSlam(cfg, pose_hook=_slam_drift_hook, device=dev)
    cum1, cum2 = [], []
    with _SyncCount() as sync1:
        feed(first, 0, ENDURANCE_RESUME_AT, counter=sync1, cum=cum1)
    path = os.path.join(out_dir, "endurance_ckpt.npz")
    torch.cuda.synchronize()
    t = time.perf_counter()
    checkpoint.save_slam(path, first)
    save_ms = (time.perf_counter() - t) * 1e3
    released = sum(kf.released for kf in first.keyframes)
    n_kf = len(first.keyframes)
    del first
    resumed = slam.SemanticSlam(cfg, pose_hook=_slam_drift_hook, device=dev)
    t = time.perf_counter()
    checkpoint.load_slam(path, resumed)
    torch.cuda.synchronize()
    load_ms = (time.perf_counter() - t) * 1e3
    size = os.path.getsize(path)
    os.remove(path)
    with _SyncCount() as sync2:
        feed(resumed, ENDURANCE_RESUME_AT, laps * n, counter=sync2, cum=cum2)
    r_res = resumed.finish()
    del resumed
    lap_syncs = np.diff([0] + cum1).tolist() + np.diff([0] + cum2).tolist()
    sync_stages = {k: sync1.by_stage.get(k, 0) + sync2.by_stage.get(k, 0)
                   for k in {**sync1.by_stage, **sync2.by_stage}}
    sync_stages = dict(sorted(sync_stages.items(), key=lambda kv: -kv[1]))
    d_raw = float(np.abs(r_res.raw_poses - res.raw_poses).max())
    d_cor = float(np.abs(r_res.poses - res.poses).max())
    log("endurance", f"resume: saved after scan {ENDURANCE_RESUME_AT}: "
        f"{size} bytes, save {save_ms:.1f} ms (flush_pipeline included), "
        f"load {load_ms:.1f} ms; {released} of {n_kf} keyframes released at "
        f"the save; resumed vs uninterrupted over {laps * n} scans: raw "
        f"max |diff| {d_raw:.3g} (limit {CKPT_RAW_ATOL}), corrected "
        f"{d_cor:.3g} (limit {CKPT_CORRECTED_ATOL}); submaps "
        f"{r_res.n_submaps} vs {res.n_submaps}, loop factors "
        f"{r_res.n_loops} vs {res.n_loops}; host syncs per lap (the "
        f"resumed pair's) {lap_syncs}, by stage over the {laps * n} scans "
        f"{json.dumps(sync_stages)}")
    with open(os.path.join(out_dir, "endurance.json"), "w") as f:
        json.dump({"scans_per_s": sps, "median_lap_scans_per_s": lap_sps,
                   "flush_s": flush_s, "lap_walls_s": walls,
                   "ate_corrected_m": ate, "ate_raw_m": raw,
                   "lap_ate_m": lap_ate.tolist(), "jax": JAX_ENDURANCE,
                   "loop_factors": res.n_loops, "lap_loop_factors": lap_loops,
                   "n_submaps": res.n_submaps, "final": final,
                   "held_keyframes": held, "graph_route": route,
                   "graph_padded_nodes": padded, "graph_solves": solves,
                   "lap_marks": marks, "peak_bytes": peak,
                   "host_max_rss_bytes": host_rss, "reckoned_bytes": per,
                   "growth_bytes": grown, "reckoned_growth_bytes": reckoned,
                   "stages_total_ms": stages, "launches": counts,
                   "syncs_per_lap": lap_syncs, "syncs_by_stage": sync_stages,
                   "downsample": down,
                   "resume": {"bytes": size, "save_ms": save_ms,
                              "load_ms": load_ms,
                              "released_at_save": released,
                              "keyframes_at_save": n_kf,
                              "raw_max_diff": d_raw,
                              "corrected_max_diff": d_cor,
                              "n_submaps": r_res.n_submaps,
                              "loop_factors": r_res.n_loops},
                   "poses": res.poses.tolist()}, f)
    check(ate < raw, f"endurance: corrected ATE {ate} >= raw {raw}")
    check(ate <= bar, f"endurance: corrected ATE {ate} > {bar}")
    check(lap_ate[-1] <= bar, f"endurance: last lap's ATE {lap_ate[-1]} > "
          f"{bar}")
    check(res.n_loops >= laps - 1, f"endurance: {res.n_loops} loop factors")
    check(all(c >= 1 for c in lap_loops[1:]),
          f"endurance: a revisit lap without a loop factor: {lap_loops}")
    check(abs(res.n_submaps - JAX_ENDURANCE["n_submaps"]) <= 2,
          f"endurance: {res.n_submaps} submaps, JAX "
          f"{JAX_ENDURANCE['n_submaps']}")
    check(final["released"] >= final["keyframes"] - held,
          f"endurance: {final['released']} of {final['keyframes']} "
          f"keyframes released, {held} held")
    check(grown <= ENDURANCE_MEM_FACTOR * reckoned,
          f"endurance: device memory grew {grown} bytes, reckoned "
          f"{reckoned}")
    check(d_raw <= CKPT_RAW_ATOL, f"endurance: resumed raw poses {d_raw}")
    check(d_cor <= CKPT_CORRECTED_ATOL,
          f"endurance: resumed corrected poses {d_cor}")
    check(r_res.n_submaps == res.n_submaps and r_res.n_loops == res.n_loops,
          "endurance: the resumed run's submaps or loop factors differ")
    check(counts[0] > 0 and counts[1] > 0, f"endurance: launches {counts}")
    err = _check_slam_kernels(system, cfg, dev, path="endurance")
    return {"endurance": counts}, err


def _endurance_child(out_dir):
    """phase_endurance in a fresh process (main starts it): the plaza
    render, the phase, and the phase's kernel cases. Returns (launches,
    (K1 err, K2 err), CASES)."""
    import torch

    dev = torch.device("cuda", 0)
    seq, gt, _ = _render_plaza(_slam_cfg(), dev)
    launches, err = phase_endurance(seq, gt, dev, out_dir)
    return launches, err, CASES


def phase_ndt(system, dev, out_dir):
    """NDT (ops/icp.build_ndt + ndt_align) between two plaza submaps: the
    third submap's surf cloud in its own frame onto the second's, seeded
    with the odometry pose; on the card against the same calls on the
    host (ms a call: build over 3 calls each, align over 3 on the card
    and 1 on the host)."""
    import torch
    from lis_slam_torch.ops import icp
    from lis_slam_torch.utils import se3

    prev, cur = system.collector.submaps[1], system.collector.submaps[2]
    T0 = torch.as_tensor(cur.pose_init.astype(np.float32))
    src = se3.transform_points(se3.transform_inverse(T0).to(dev),
                               cur.surf_xyz).contiguous()
    runs = {}
    for name, d in (("card", dev), ("host", torch.device("cpu"))):
        args = (prev.surf_xyz.to(d), prev.surf_mask.to(d))
        grid = icp.build_ndt(*args)
        res = icp.ndt_align(src.to(d), cur.surf_mask.to(d), grid, T0)
        sync = torch.cuda.synchronize if d.type == "cuda" else (lambda: None)
        # one timed align on the host: its loop takes seconds a call
        reps = 3 if d.type == "cuda" else 1
        t = time.perf_counter()
        for _ in range(3):
            icp.build_ndt(*args)
        sync()
        build_ms = (time.perf_counter() - t) / 3 * 1e3
        t = time.perf_counter()
        for _ in range(reps):
            icp.ndt_align(src.to(d), cur.surf_mask.to(d), grid, T0)
        align_ms = (time.perf_counter() - t) / reps * 1e3
        runs[name] = (grid, res, build_ms, align_ms)
    (gc, rc, bc, ac), (gh, rh, bh, ah) = runs["card"], runs["host"]
    d_T = float(torch.max(torch.abs(rc.transform - rh.transform)))
    d_info = float(torch.max(torch.abs(gc.info.cpu() - gh.info)))
    same_grid = bool(torch.equal(gc.mask.cpu(), gh.mask)
                     and torch.equal(gc.mean.cpu(), gh.mean))
    moved = float(torch.linalg.vector_norm(rc.transform[:3, 3] - T0[:3, 3]))
    log("ndt", f"submap {cur.index} ({int(cur.surf_mask.sum())} surf points) "
        f"onto submap {prev.index} ({int(prev.surf_mask.sum())}; "
        f"{int(gc.mask.sum())} voxel Gaussians): card {rc.iterations} "
        f"iterations, converged {rc.converged}, {rc.n_inliers} inliers, "
        f"fitness {rc.fitness:.5f}; host {rh.iterations}, {rh.converged}, "
        f"{rh.n_inliers}; transform max |card - host| {d_T:.3g} (limit "
        f"{NDT_ATOL}), grids equal {same_grid}, info max |diff| "
        f"{d_info:.3g}; moved {moved:.4f} m from the odometry seed; "
        f"build_ndt {bc:.3f} ms card / {bh:.3f} ms host, ndt_align "
        f"{ac:.3f} / {ah:.3f} ms (host clock, a call)")
    with open(os.path.join(out_dir, "ndt.json"), "w") as f:
        json.dump({"iterations": [rc.iterations, rh.iterations],
                   "converged": [rc.converged, rh.converged],
                   "transform_max_diff": d_T, "info_max_diff": d_info,
                   "build_ms": [bc, bh], "align_ms": [ac, ah]}, f)
    check(d_T <= NDT_ATOL, f"ndt: card vs host transform {d_T}")
    check(rc.iterations == rh.iterations and rc.converged == rh.converged,
          "ndt: iterations or convergence differ")
    check(rc.n_inliers > 1000, f"ndt: {rc.n_inliers} inliers")


def phase_train(dev, out_dir):
    """TRAIN_STEPS RangeNet training steps (train/seg_train.py) at the
    full darknet53 width, 64 x 2048 x 5, bf16, batch TRAIN_BATCH, on one
    seeded batch; then the trained weights as SemanticSlam's
    rangenet_params, labelling a plaza scan."""
    import torch
    from lis_slam_torch.config import SemanticConfig, SensorConfig, SlamConfig
    from lis_slam_torch.pipeline import slam
    from lis_slam_torch.semantic import inference
    from lis_slam_torch.train import seg_train

    full = SemanticConfig(enabled=True)
    check(full.fp16, "train: the default SemanticConfig is not bf16")
    model, opt = seg_train.create_train_state(
        full, torch.Generator().manual_seed(0), lr=TRAIN_LR, device=dev)
    step = seg_train.make_train_step(model, opt)
    images, labels, mask = (torch.as_tensor(a, device=dev)
                            for a in _train_inputs(full))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, norms, ms = [], [], []
    for _ in range(TRAIN_STEPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        m = step(images, labels, mask)
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    peak = torch.cuda.max_memory_allocated()
    tree = seg_train.to_variables(model, full)
    del model, opt, step
    cfg = SlamConfig().replace(sensor=SensorConfig(max_raw_points=64 * 1800),
                               semantic=full)
    system = slam.SemanticSlam(cfg, rangenet_params=tree, device=dev)
    pts, lab_gt, valid = _plaza_scan(dev, 1800, 19)
    with torch.no_grad():
        lab, _sem = inference.infer_scan_labels(system.model, pts, valid,
                                                system._infer_cfg)
    n_lab = int((valid & (lab > 0)).sum())
    log("train", f"darknet53 {TRAIN_BATCH} x {full.model_input_h} x "
        f"{full.model_input_w} x {full.model_input_c} bf16, Adam lr "
        f"{TRAIN_LR}: losses {', '.join(f'{x:.4f}' for x in losses)}; grad "
        f"norms {', '.join(f'{x:.3f}' for x in norms)}; ms a step (CUDA "
        f"events) {', '.join(f'{x:.2f}' for x in ms)}; peak device memory "
        f"{peak} bytes; the trained weights in SemanticSlam labelled "
        f"{n_lab} of {int(valid.sum())} points of a plaza scan")
    with open(os.path.join(out_dir, "train.json"), "w") as f:
        json.dump({"losses": losses, "grad_norms": norms, "step_ms": ms,
                   "peak_bytes": peak, "labelled_points": n_lab}, f)
    check(bool(np.isfinite(losses).all() and np.isfinite(norms).all()),
          f"train: loss or grad norm not finite ({losses}, {norms})")
    check(losses[-1] < losses[0], f"train: loss did not fall ({losses})")
    check(lab.shape == valid.shape and int(lab.min()) >= 0
          and int(lab.max()) < full.num_classes and n_lab > 0,
          "train: the trained weights labelled no point")


# ---------------------------------------------------------------------------
# projection: the unfused pair; recipe: the slim checkpoint retrained
# ---------------------------------------------------------------------------

PROJ_FUSED_ATOL = 0.02  # m, fused vs pair (tests/test_frontend_ops.py:300)
# points a scan whose column the card's atan2 may move, as a share of the
# valid points: ~25% of them get another last bit, of which ~7e-5 lie
# that close to a half column (~2 expected of 112k; 1 measured)
PROJ_MOVED_MAX = 1e-4
RECIPE_STEPS = 2500  # the shipped slim checkpoint's meta "steps"
RECIPE_BATCH = 8
RECIPE_LR = 2e-3
RECIPE_MIOU_MIN = 0.95  # held-out mIoU of the retrained checkpoint


def _moved_pixels(pre_d, pre_c, ok, h):
    """(raw indices, pixel set) of the in-grid points whose column the
    card and the host compute differently: the card's float32 atan2 is
    not the host's in the last bit for ~25% of points, which moves a
    point that lies on a half column into the next one."""
    from lis_slam_torch.ops import projection

    col_d = projection.pixel_columns(pre_d.points[:, :3], h).cpu()
    col_c = projection.pixel_columns(pre_c.points[:, :3], h)
    moved = (ok & (col_d != col_c)).nonzero()[:, 0]
    ring = pre_c.ring[moved]
    pixels = {(int(r), int(c) % h) for r, c in zip(ring, col_d[moved])}
    pixels |= {(int(r), int(c) % h) for r, c in zip(ring, col_c[moved])}
    return moved, pixels


def phase_projection(dev, out_dir):
    """The unfused projection pair (ops/projection.py project + extract)
    on a full HDL-64 plaza scan (64 x 1800, P = 115200) with its labels in
    the rel_time channel, as the recipe projects: the card against the
    host on the same pretreated points (bit-equal outside the pixels of
    points whose column the two devices' atan2 puts apart, which are
    counted), the card's fused project_and_extract against the card's
    pair (masks, counts and columns equal, ranges within
    PROJ_FUSED_ATOL), and ms a call of both (CUDA events)."""
    import torch
    from lis_slam_torch.config import SensorConfig, SlamConfig
    from lis_slam_torch.ops import pretreatment, projection

    cfg = SlamConfig().replace(
        sensor=SensorConfig(max_raw_points=64 * 1800)).sensor
    n, h = cfg.n_scan, cfg.horizon_scan
    pts, lab, valid = _plaza_scan(dev, h, 29)
    check(pts.shape[0] == n * h, f"projection: {pts.shape[0]} points")
    pre_d = pretreatment.pretreat(pts, valid, cfg)
    pre_c = pretreatment.PretreatedCloud(*(t.cpu() for t in pre_d))
    args_d = (pre_d.points[:, :3], pre_d.points[:, 3], pre_d.ring,
              lab.to(torch.float32), pre_d.valid)
    args_c = tuple(a.cpu() for a in args_d)
    img_d = projection.project(*args_d, cfg)
    ext_d = projection.extract(img_d)
    img_c = projection.project(*args_c, cfg)
    ext_c = projection.extract(img_c)
    ok = pre_c.valid & (pre_c.ring >= 0) & (pre_c.ring < n)
    moved, pixels = _moved_pixels(pre_d, pre_c, ok, h)
    check(moved.numel() <= PROJ_MOVED_MAX * int(valid.sum()),
          f"projection: the card moves {moved.numel()} points' columns")
    spared = torch.ones((n, h), dtype=torch.bool)
    for r, c in pixels:
        spared[r, c] = False
    rows = spared.all(dim=1)
    diff_img = {f: int((getattr(img_d, f).cpu() != getattr(img_c, f))
                       .reshape(n, h, -1).any(-1).sum())
                for f in img_c._fields}
    for f in img_c._fields:
        a, b = getattr(img_d, f).cpu(), getattr(img_c, f)
        check(torch.equal(a[spared], b[spared]),
              f"projection: image {f} differs card vs host outside the "
              f"{len(pixels)} pixels of moved points")
    for f in ext_c._fields:
        a, b = getattr(ext_d, f).cpu(), getattr(ext_c, f)
        if a.dim() == 1:
            a, b = a[:, None], b[:, None]
        check(torch.equal(a[rows], b[rows]),
              f"projection: extract {f} differs card vs host outside "
              f"the rows of moved points")
    check(bool((ext_c.src == -1).all()), "projection: extract src not -1")
    mask = img_d.mask
    check(int(mask.sum()) > 10000 and not bool(mask[1::2].any()),
          f"projection: {int(mask.sum())} pixels or an odd row filled")
    img_f, ext_f = projection.project_and_extract(*args_d, cfg,
                                                  want_image=True)
    gap = float((img_f.rng - img_d.rng)[mask].abs().max())
    gap_ext = float((ext_f.rng - ext_d.rng)[ext_d.mask].abs().max())
    same = {"mask": torch.equal(img_f.mask, mask),
            "count": torch.equal(ext_f.count, ext_d.count),
            "col": torch.equal(ext_f.col, ext_d.col)}

    def pair():
        return projection.extract(projection.project(*args_d, cfg))

    def fused():
        return projection.project_and_extract(*args_d, cfg, want_image=True)

    pair_ms, fused_ms = call_ms(pair, iters=50), call_ms(fused, iters=50)
    log("projection", f"project + extract on a {n} x {h} scan "
        f"({int(valid.sum())} of {pts.shape[0]} points valid, "
        f"{int(mask.sum())} pixels filled): card vs host bit-equal outside "
        f"{len(pixels)} pixels of {moved.numel()} points whose column the "
        f"card's atan2 moves (pixels differing by field: "
        f"{json.dumps(diff_img)}; extract rows compared {int(rows.sum())} "
        f"of {n}); fused vs pair on the card: mask/count/col equal "
        f"{json.dumps(same)}, range gap image {gap:.6f} m, extracted "
        f"{gap_ext:.6f} m (limit {PROJ_FUSED_ATOL}); ms a call (CUDA "
        f"events): pair {pair_ms:.4f}, fused {fused_ms:.4f}")
    with open(os.path.join(out_dir, "projection.json"), "w") as f:
        json.dump({"moved_points": moved.tolist(), "moved_pixels":
                   sorted(pixels), "pixels_differing": diff_img,
                   "fused_same": same, "fused_rng_gap_m": gap,
                   "fused_ext_rng_gap_m": gap_ext, "pair_ms": pair_ms,
                   "fused_ms": fused_ms}, f)
    check(all(same.values()), f"projection: fused vs pair {same}")
    check(max(gap, gap_ext) < PROJ_FUSED_ATOL,
          f"projection: fused vs pair range gap {gap} / {gap_ext}")


def phase_recipe(dev, out_dir):
    """The synthetic RangeNet recipe (train/recipe.py) at full width: the
    88-image dataset rendered on the card, RECIPE_STEPS steps of the slim
    net on 512-wide crops, batch 8, bf16, the held-out mIoU beside the
    shipped checkpoint's; the checkpoint written and read back, its
    per-point accuracy on a plaza scan, and the plaza lap with labels
    inferred by it (SemanticSlam(rangenet_params=...), the lap rendered
    anew), held to the slam_infer phase's bar."""
    import dataclasses

    import torch
    from lis_slam_torch.config import SensorConfig, SlamConfig
    from lis_slam_torch.config import slim_semantic_config
    from lis_slam_torch.pipeline import trajectory
    from lis_slam_torch.semantic import inference, weights
    from lis_slam_torch.train import recipe

    shipped = json.loads(str(np.load(weights.DEFAULT_CHECKPOINT)
                             ["__meta__"]))
    torch.cuda.synchronize()
    t = time.perf_counter()
    data = recipe.render_dataset(device=dev)
    torch.cuda.synchronize()
    render_s = time.perf_counter() - t
    check(tuple(data.images.shape) == (88, 64, recipe.H_PAD, 5),
          f"recipe: dataset {tuple(data.images.shape)}")
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    res = recipe.train(RECIPE_STEPS, batch=RECIPE_BATCH, lr=RECIPE_LR,
                       data=data, device=dev)
    total_s = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated()
    losses = list(res.losses.values())
    step_ms = 1e3 * res.seconds / RECIPE_STEPS
    log("recipe", f"dataset {tuple(data.images.shape)} rendered on the card "
        f"in {render_s:.3f} s; {RECIPE_STEPS} steps of the slim net "
        f"(batch {RECIPE_BATCH} x 64 x {recipe.CROP_W}, bf16) in "
        f"{res.seconds:.3f} s = {step_ms:.3f} ms a step (host clock, "
        f"synced), {total_s:.3f} s with the held-out eval; peak device "
        f"memory {peak} bytes; held-out mIoU "
        f"{res.miou:.4f} (limit >= {RECIPE_MIOU_MIN}; the shipped "
        f"checkpoint's {shipped['miou_synthetic']:.4f} after "
        f"{shipped['steps']} steps of the JAX script), per class "
        f"{json.dumps(res.per_class)}")
    log("recipe", "loss every 100 steps: " + json.dumps(
        {k: round(v, 5) for k, v in res.losses.items()}))
    path = os.path.join(out_dir, "recipe_slim.npz")
    weights.save_checkpoint(path, res.variables, slim_semantic_config(),
                            meta={"miou_synthetic": res.miou,
                                  "steps": RECIPE_STEPS})
    sem, variables = weights.load_checkpoint(path)
    del data
    # the checkpoint per raw point of a plaza scan (phase_semantic's)
    cfg = SlamConfig().replace(sensor=SensorConfig(max_raw_points=64 * 1800))
    pts, lab_gt, valid = _plaza_scan(dev, 1800, 13)
    model = inference.SemanticInference(cfg, checkpoint=path, device=dev)
    lab, _ = model(pts, valid)
    m = valid & (lab > 0)
    acc = float((lab[m] == lab_gt[m].to(lab.dtype)).float().mean())
    # the plaza lap, labels inferred on every keyframe by it
    base = _slam_cfg()
    seq, gt, _ = _render_plaza(base, dev)
    cfg = base.replace(semantic=dataclasses.replace(sem, enabled=True))
    _slam_run(cfg, seq[:SLAM_WARMUP], dev, "recipe", labels=False,
              rangenet_params=variables)
    system, res_slam, sps, counts, lap_peak = _slam_run(
        cfg, seq, dev, "recipe", labels=False, rangenet_params=variables)
    gt_rel = trajectory.relative_to_first(gt)
    ate = trajectory.ate_rmse(res_slam.poses, gt_rel, align=True)
    raw = trajectory.ate_rmse(res_slam.raw_poses, gt_rel, align=True)
    jx = JAX_SLAM_INFER
    bar = 1.5 * jx["ate_corrected_m"] + 0.02
    log("recipe", f"checkpoint written ({os.path.getsize(path)} bytes) and "
        f"read back: per-point label accuracy {acc:.4f} on {int(m.sum())} "
        f"labelled plaza points (limit > {SEM_ACC_MIN}); SemanticSlam "
        f"with rangenet_params on the plaza lap: {sps:.3f} scans/s, ATE "
        f"aligned corrected {ate:.4f} m, raw {raw:.4f} m (limit {bar:.4f}, "
        f"the slam_infer bar), submaps {res_slam.n_submaps}, loop factors "
        f"{res_slam.n_loops}, keyframes {len(system.keyframes)}; K1 "
        f"launches {counts[0]}, K2 launches {counts[1]}; peak device "
        f"memory {lap_peak} bytes")
    with open(os.path.join(out_dir, "recipe.json"), "w") as f:
        json.dump({"render_s": render_s, "train_s": res.seconds,
                   "step_ms": step_ms,
                   "total_s": total_s, "peak_bytes": peak,
                   "losses": res.losses, "miou": res.miou,
                   "per_class": res.per_class, "shipped": shipped,
                   "label_accuracy": acc, "ate_corrected_m": ate,
                   "ate_raw_m": raw, "scans_per_s": sps,
                   "n_submaps": res_slam.n_submaps,
                   "loop_factors": res_slam.n_loops,
                   "keyframes": len(system.keyframes),
                   "launches": counts}, f)
    check(bool(np.isfinite(losses).all()), f"recipe: loss {losses}")
    check(np.mean(losses[-5:]) < 0.5 * losses[0],
          f"recipe: the loss did not fall ({losses})")
    check(res.miou >= RECIPE_MIOU_MIN, f"recipe: held-out mIoU {res.miou}")
    check(acc > SEM_ACC_MIN, f"recipe: label accuracy {acc}")
    check(res_slam.n_loops >= 1, "recipe: no loop factor")
    check(ate <= bar, f"recipe: corrected ATE {ate} > {bar}")
    check(counts[0] > 0 and counts[1] > 0, f"recipe: launches {counts}")
    return {"recipe": counts}


# ---------------------------------------------------------------------------
# batched: multi-sequence replay through the uniform step (K1 + K2 + K3)
# ---------------------------------------------------------------------------

BATCH_LANES = 8
BATCH_SCANS = 24
BATCH_RATE_LANES = (1, 8, 32)
BATCH_RATE_STEPS = 16  # timed steps per rate, after BATCH_RATE_WARMUP
BATCH_RATE_WARMUP = 4
BATCH_RATE_TURNS = 3  # with --baseline: turns of baseline, this, this, baseline
BATCH_SINGLE_ATOL = 5e-3  # m, lane 0 (kf every scan) vs odom_step_uniform
# K3 against its plain version on recorded normal equations
K3_POSE_ATOL = 1e-5
K3_PROJ_ATOL = 1e-4
K3_NO_LIBRARY = ("two PyTorch calls compute part of it: torch.linalg.eigh + "
                 "torch.linalg.solve over (B, 6, 6), timed as library_ms")


def _lane_starts(lanes: int, n_scans: int):
    """Lanes 0 and 1 start at scan 0; lane b >= 2 at 4 (b - 1), wrapped so
    that BATCH_SCANS scans remain."""
    room = n_scans - BATCH_SCANS + 1
    return [0, 0][:lanes] + [(4 * (b - 1)) % room for b in range(2, lanes)]


def _batched_cfg(cfg, backend, kf_every=None):
    import dataclasses

    c = cfg.replace(matching=dataclasses.replace(cfg.matching,
                                                 gn_backend=backend))
    if kf_every is not None:
        c = c.replace(runtime=dataclasses.replace(c.runtime,
                                                  batched_kf_every=kf_every))
    return c


def _warm_lanes(scans, cfg, lanes, steps, pkg=None):
    """States of `lanes` lanes after `steps` batched steps (on the
    replay's cadence), and the stacked scans of the steps that follow;
    `pkg` names --baseline's package."""
    batched = _pkg_mod(pkg, "parallel.batched")
    starts = _lane_starts(lanes, len(scans))
    stacked = [batched.stack_scans([scans[s + i] for s in starts])
               for i in range(BATCH_SCANS)]
    kf_every = max(1, cfg.runtime.batched_kf_every)
    states = batched.batched_init_state(cfg, lanes, scans[0].points.device)
    for i in range(steps):
        states, _ = batched.batched_odom_step(states, stacked[i], cfg,
                                              allow_kf=(i % kf_every == 0))
    return states, stacked


def _step_kernels(scans, cfg, lanes, windows=3, pkg=None):
    """One warm batched step (a keyframe-merge step) under torch.profiler,
    traced in `windows` windows; the window with the most CUDA activities
    is kept, since a trace can drop activities (once in a whole run on
    the H100: 1363 recorded at B = 8 against 1431 at B = 1, where eight
    repeated windows of the phase alone all read 1434 at both). Returns
    (CUDA activities by name, K1/K2/K3 launches, device busy ms, wall ms,
    aten ops, every window's activity total)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    batched = _pkg_mod(pkg, "parallel.batched")
    step = 2 * max(1, cfg.runtime.batched_kf_every)  # merges (i % K == 0)
    states, stacked = _warm_lanes(scans, cfg, lanes, step, pkg)
    # a second warm step of the same kind, so the allocator has the sizes
    batched.batched_odom_step(states, stacked[step], cfg)
    torch.cuda.synchronize()
    best, totals = None, []
    for _ in range(windows):
        _zero_launches(pkg)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            batched.batched_odom_step(states, stacked[step], cfg)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t) * 1e3
        launches = _launches(pkg)
        names: dict[str, int] = {}
        busy, ops = 0.0, 0
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                n = e.name.split("(")[0][-80:]
                names[n] = names.get(n, 0) + 1
                busy += (e.time_range.end - e.time_range.start) / 1e3
            elif e.name.startswith("aten::"):
                ops += 1
        totals.append(sum(names.values()))
        if best is None or totals[-1] > sum(best[0].values()):
            best = (names, launches, busy, wall, ops)
    return (*best, totals)


def _rate(scans, cfg, lanes, pkg=None):
    """Aggregate scans/s of `lanes` lanes over BATCH_RATE_STEPS batched
    steps on the replay's cadence, after BATCH_RATE_WARMUP, and the peak
    device memory of the run."""
    import torch

    batched = _pkg_mod(pkg, "parallel.batched")
    torch.cuda.reset_peak_memory_stats()
    states, stacked = _warm_lanes(scans, cfg, lanes, BATCH_RATE_WARMUP, pkg)
    kf_every = max(1, cfg.runtime.batched_kf_every)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for i in range(BATCH_RATE_WARMUP, BATCH_RATE_WARMUP + BATCH_RATE_STEPS):
        states, _ = batched.batched_odom_step(states, stacked[i], cfg,
                                              allow_kf=(i % kf_every == 0))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    return (lanes * BATCH_RATE_STEPS / wall,
            torch.cuda.max_memory_allocated())


def _check_no_syncs(scans, cfg):
    """batched_odom_step under torch.cuda.set_sync_debug_mode("error"),
    warm, on a merge step and a merge-free step: any synchronizing CUDA
    call raises."""
    import torch
    from lis_slam_torch.parallel import batched

    kf_every = max(1, cfg.runtime.batched_kf_every)
    states, stacked = _warm_lanes(scans, cfg, BATCH_LANES, kf_every)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for i in range(kf_every, kf_every + 2):
            states, out = batched.batched_odom_step(
                states, stacked[i], cfg, allow_kf=(i % kf_every == 0))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return 2


def _record_k3(run):
    """The normal equations and lane states K3 was called with during
    run(), recorded through the module attribute the solver calls."""
    from lis_slam_torch.ops import gn_solve

    calls, solve = [], gn_solve.solve

    def record(hg, st, c):
        calls.append((hg.clone(), type(st)(*(t.clone() for t in st))))
        return solve(hg, st, c)

    record.launches = solve.launches  # the K3 wrapper counts on this name
    gn_solve.solve = record
    try:
        run()
    finally:
        gn_solve.solve = solve
        solve.launches = record.launches
    return calls


def _record_k3_lanes(scans, cfg, lanes):
    """K3's calls during one warm merge-free batched step of `lanes` lanes
    (the fourth), with the states and the scans of that step."""
    from lis_slam_torch.parallel import batched

    states, stacked = _warm_lanes(scans, cfg, lanes, 3)
    calls = _record_k3(lambda: batched.batched_odom_step(
        states, stacked[3], cfg, allow_kf=False))
    return calls, states, stacked[3]


# K3's work a lane: the host's sequence of 90 rotations, once a lane (the
# kernel's threads recompute partial sums and the round's (c, s), which
# the bound does not count): a rotation's (c, s) 30 float64 flops
# (csrc/gn_solve.cu half_angle: x and y 3, x^2 + y^2 3, two reciprocal
# square roots with their Newton step 8 each, r and r d 3, c and s 5),
# its row stage, column stage and V update 12 values each at 3 flops;
# float32: solve6 ~250, the projector 36 x 18, px 72, the norms 12; the
# rows ~350 (3 sincos ~60, R ~20, six 3x3 products 270), also for a
# frozen lane and the rows-only launch
K3_F64_SOLVE = 90 * (30 + 3 * 12 * 3)
K3_F32_SOLVE = 250 + 36 * 18 + 72 + 12
K3_F32_ROWS = 350
K3_RATE_LANES = (1, 8, 32)  # the batched rate lanes
K3_HOST_CALLS = 200


def _k3_bound(st):
    """K3's bound for one launch on the lane state st: hg (43 f32) of the
    lanes still active, the lane state in and out (pose 6 + proj 36 f32,
    two bools, two int32, two f32) and the rows (128 f32) each moved
    once; K3_F64_SOLVE over the float64 peak and K3_F32_SOLVE over the
    float32 peak for each active lane, K3_F32_ROWS for every lane."""
    lanes = st.pose.shape[0]
    active = int((~st.converged).sum())
    state = 4 * (6 + 36) + 2 + 4 * 2 + 4 * 2
    nbytes = active * 43 * 4 + lanes * (2 * state + 128 * 4)
    return _bound(nbytes, active * K3_F32_SOLVE + lanes * K3_F32_ROWS,
                  f"{active} active of {lanes} lanes", active * K3_F64_SOLVE)


def _empty_launch_ms():
    """Device ms of one empty kernel launch (torch.cuda._sleep(0): a
    kernel that spins 0 cycles), by the same profiler count as the
    kernels: the practical floor of a launch on this card."""
    import torch

    return device_ms(lambda: torch.cuda._sleep(0))[0]


def _k3_host_ms(hg, st, cfg):
    """Host ms of one K3 call, host clock over K3_HOST_CALLS back-to-back
    calls with no sync inside (the device keeps up: its time is a fraction
    of the host's): the whole wrapper; its output allocation alone
    (gn_solve._outputs, nine tensors); the same outputs as views of one
    float32 and one bool allocation (the trim considered); its ctypes
    call with lanes = 0 (argument marshalling, no launch)."""
    import torch
    from lis_slam_torch.ops import cuda_build, gn_solve

    out, rows = gn_solve._outputs(st)
    m, dev = cfg, st.pose.device
    args = [hg.data_ptr(), *(t.data_ptr() for t in st),
            *(t.data_ptr() for t in out), rows.data_ptr(), 0, 1,
            m.degeneracy_eigen_threshold, m.min_valid_points,
            m.converge_delta_r_deg, m.converge_delta_t_cm, m.nn_max_sq_dist,
            m.residual_damping, m.min_residual_weight, m.eigen_ratio_line,
            m.plane_fit_tolerance]

    def no_launch():
        cuda_build.check(gn_solve._lib().lis_gn_solve(
            *args, cuda_build.stream_ptr(dev)), "gn_solve")

    def flat_outputs():  # the same outputs as views of two allocations
        b = st.pose.shape[0]
        f = torch.empty(b * 174, dtype=torch.float32, device=dev)
        flags = torch.empty(2 * b, dtype=torch.bool, device=dev)
        rows_, pose, proj, n_valid, it, d_r, d_t = torch.split(
            f, [128 * b, 6 * b, 36 * b, b, b, b, b])
        return (rows_.view(b, 2, 64), pose.view(b, 6), proj.view(b, 6, 6),
                flags[:b], flags[b:], n_valid.view(torch.int32),
                it.view(torch.int32), d_r, d_t)

    res = {}
    for key, fn in (("host_ms", lambda: gn_solve.solve(hg, st, cfg)),
                    ("host_alloc_ms", lambda: gn_solve._outputs(st)),
                    ("host_alloc_flat_ms", flat_outputs),
                    ("host_ctypes_no_launch_ms", no_launch)):
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(K3_HOST_CALLS):
            fn()
        res[key] = (time.perf_counter() - t) / K3_HOST_CALLS * 1e3
        torch.cuda.synchronize()
    return res


def _check_k3(calls, cfg, path, host=False):
    """K3 against its plain version on every recorded call: flags and it
    equal, pose within K3_POSE_ATOL, proj within K3_PROJ_ATOL. Then its
    times on the middle call (CASES["K3"]; with --baseline, the baseline
    checkout's K3 on the same inputs in turns), with torch.linalg.eigh +
    torch.linalg.solve on the same (B, 6, 6) as the library pair, an
    empty launch's device ms beside it, and with `host` the wrapper's
    host ms (_k3_host_ms). Returns the largest pose error."""
    import torch
    from lis_slam_torch.ops import gn_solve

    err = e_proj = e_rows = 0.0
    for hg, st in calls:
        new, rows = gn_solve.solve(hg, st, cfg.matching)
        ref, ref_rows = gn_solve.solve_plain(hg, st, cfg.matching)
        torch.cuda.synchronize()
        for f in ("degenerate", "converged", "n_valid", "it"):
            check(bool(torch.equal(getattr(new, f), getattr(ref, f))),
                  f"K3: {f} differs from the plain version: "
                  f"{getattr(new, f).tolist()} vs {getattr(ref, f).tolist()}")
        e_pose = float((new.pose - ref.pose).abs().max())
        e_proj = max(e_proj, float((new.proj - ref.proj).abs().max()))
        e_rows = max(e_rows, float((rows - ref_rows).abs().max()))
        check(e_pose <= K3_POSE_ATOL and e_proj <= K3_PROJ_ATOL,
              f"K3: pose err {e_pose}, proj err {e_proj}")
        err = max(err, e_pose)
    hg, st = calls[len(calls) // 2]
    lanes = hg.shape[0]
    log("K3", f"{path}: {len(calls)} recorded calls at B {lanes}: flags "
        f"and it equal, max |pose - plain| {err:.3g}, proj err "
        f"{e_proj:.3g}, rows err {e_rows:.3g}; degenerate lanes "
        f"{int(ref.degenerate.sum())}, converged {int(ref.converged.sum())} "
        "after the last")
    H = hg[:, :36].reshape(-1, 6, 6)
    g = hg[:, 36:42]

    def library():
        torch.linalg.eigh(H)
        torch.linalg.solve(H, g)

    base = None if BASELINE is None else (
        lambda: BASELINE.gn_solve.solve(hg, st, cfg.matching))
    extra = dict(active_lanes=int((~st.converged).sum()),
                 empty_launch_ms=_empty_launch_ms())
    if host:
        extra.update(_k3_host_ms(hg, st, cfg.matching))
    case = _timed("K3", "K3", f"B{lanes} (43 + state)", path,
                  lambda: gn_solve.solve(hg, st, cfg.matching),
                  lambda: gn_solve.solve_plain(hg, st, cfg.matching),
                  _k3_bound(st), base_fn=base, library_none_reason=None,
                  **extra)
    case["library_ms"] = call_ms(library)
    case["library_what"] = "torch.linalg.eigh + torch.linalg.solve (B, 6, 6)"
    log("K3", f"{path} B{lanes}: library pair eigh + solve "
        f"{case['library_ms']:.4f} ms")
    return err


def _check_batched_kernels(states, scans_b, cfg, path="batched"):
    """K1 and K2 at the batched shapes: the lanes' matched clouds of the
    next scan against their maps, at the lanes' poses. K1 per lane
    bit-equal to knn_plain (tiles skipped share); K2, which builds the
    lanes' rows and sums in float64, per lane within GN_ATOL scaled of its
    plain version in float64 with n_valid equal (the float32 plain
    version's distance printed beside); both timed."""
    import torch
    from lis_slam_torch.ops import gn_cuda, gn_solve, knn_cuda
    from lis_slam_torch.pipeline import odometry
    from lis_slam_torch.utils import se3

    m = cfg.matching
    k = m.nn_cache_k
    fc = odometry.preprocess(scans_b, cfg)
    qc, qc_mask, qs, qs_mask = odometry._matched_clouds(fc, cfg)
    qc, qc_mask, _ = _sorted_lanes(qc, qc_mask)
    qs, qs_mask, _ = _sorted_lanes(qs, qs_mask)
    pose = states.pose + torch.tensor(POSE_OFF, device=states.pose.device)
    T = se3.pose_to_matrix(pose)
    lanes = pose.shape[0]
    err1, clouds = 0.0, {}
    for mode, q, q_mask, ref, ref_mask in (
            ("corner", qc, qc_mask, states.map_corner, states.map_corner_mask),
            ("surf", qs, qs_mask, states.map_surf, states.map_surf_mask)):
        qw = se3.transform_points(T, q).contiguous()
        ref, ref_mask = ref.contiguous(), ref_mask.contiguous()
        d, i, cand = knn_cuda.knn_lanes(qw, ref, ref_mask, k=k,
                                        max_sq_dist=4.0)
        dp, ip, xp = knn_cuda.knn_lanes_plain(qw, ref, ref_mask, k=k,
                                              max_sq_dist=4.0)
        torch.cuda.synchronize()
        check(bool(torch.equal(d, dp) and torch.equal(i, ip)
                   and torch.equal(cand, xp)),
              f"K1 batched {mode}: not bit-equal to the plain version")
        done, total = knn_cuda.tiles_computed(qw, ref, ref_mask, k=k,
                                              max_sq_dist=4.0)
        bound = _k1_lanes_bound(qw, ref, ref_mask, k, 4.0)
        _timed("K1", "K1", f"{mode} B{lanes} Q{q.shape[1]} "
               f"N{ref.shape[1]} k{k} cap4", path,
               lambda: knn_cuda.knn_lanes(qw, ref, ref_mask, k=k,
                                          max_sq_dist=4.0),
               lambda: knn_cuda.knn_lanes_plain(qw, ref, ref_mask, k=k,
                                                max_sq_dist=4.0),
               bound, library_none_reason=K1_NO_LIBRARY,
               tiles_computed=done, tiles_total=total,
               tiles_skipped_share=1.0 - done / max(total, 1))
        log("K1", f"{path} {mode} B{lanes}: every lane bit-equal to the "
            f"plain version, tiles skipped {1.0 - done / max(total, 1):.4f}")
        clouds[mode] = (q.contiguous(), q_mask.contiguous(), cand,
                        (d < 4.0).contiguous(), None)
    st = gn_solve.init_state(pose.contiguous())
    rows = gn_solve.scalar_rows(st, m)
    args = (rows, *clouds["corner"][:4], *clouds["surf"][:4], None, None, k)
    hg = gn_cuda.gn_iteration_lanes(*args)
    hg2 = gn_cuda.gn_iteration_lanes(*args)
    torch.cuda.synchronize()
    check(bool(torch.equal(hg, hg2)), "K2 batched: not reproducible")
    cl = (*clouds["corner"][:4], *clouds["surf"][:4], None, None, k)
    ref = gn_cuda.gn_iteration_lanes_plain(rows, *cl)
    ref32 = gn_cuda.gn_iteration_lanes_plain(rows, *cl, torch.float32)
    err2, err32 = 0.0, 0.0
    for b in range(lanes):
        Hk, gk = hg[b, :36].reshape(6, 6), hg[b, 36:42]
        Hd, gd = ref[b, :36].reshape(6, 6), ref[b, 36:42]
        check(int(hg[b, 42]) == int(ref[b, 42]),
              f"K2 batched lane {b}: n_valid {int(hg[b, 42])} vs the float64 "
              f"plain version's {int(ref[b, 42])}")
        e_k = max(_scaled_err(Hk, gk, Hd, gd))
        check(e_k <= GN_ATOL, f"K2 batched lane {b}: scaled error {e_k:.3g} "
              f"against the float64 plain version")
        err2 = max(err2, e_k)
        err32 = max(err32, max(_scaled_err(ref32[b, :36].reshape(6, 6),
                                           ref32[b, 36:42], Hd, gd)))
    log("K2", f"{path} B{lanes}: every lane within {GN_ATOL} scaled of the "
        f"float64 plain version, n_valid equal; max scaled err {err2:.3g} "
        f"(the float32 plain version: {err32:.3g})")
    plain = lambda: gn_cuda.gn_iteration_lanes_plain(rows, *cl)  # noqa: E731
    kb = _k2_bound([(clouds[m_][0].reshape(-1, 3),
                     clouds[m_][1].reshape(-1), None)
                    for m_ in ("corner", "surf")], k, lanes=lanes, f64=True)
    _timed("K2", "K2", f"B{lanes} corner Q{qc.shape[1]} + surf "
           f"Q{qs.shape[1]} k{k}", path,
           lambda: gn_cuda.gn_iteration_lanes(*args), plain, kb,
           library_none_reason=K2_NO_LIBRARY)
    return err2


def _k1_lanes_bound(q, ref, mask, k, cap):
    """K1's bound over lanes: _k1_bound's bytes and pairs within the cap,
    summed over the lanes of one launch."""
    from lis_slam_torch.ops import knn

    lanes, q_n, n = q.shape[0], q.shape[1], ref.shape[1]
    nbytes = lanes * (q_n * 12 + n * 13 + q_n * k * 20)
    pairs = 0
    for b in range(lanes):
        valid = ref[b][mask[b]]
        pairs += sum(int((knn.sq_dist(q[b, s:s + 256], valid) < cap).sum())
                     for s in range(0, q_n, 256))
    return _bound(nbytes, 8 * pairs, "8 x pairs within the cap, all lanes")


def _sorted_lanes(pts, mask):
    from lis_slam_torch.ops import scan_match

    return scan_match._morton_sort_queries(pts, mask, None)


def phase_batched(scans, gt, cfg, dev, out_dir):
    """Batched multi-sequence replay (parallel/batched.py) at full width:
    B = 8 lanes of 24 circuit scans each (lanes 0 and 1 the same
    sequence, lane b >= 2 from scan 4 (b - 1)), both GN backends; then the
    single-sequence uniform step, the host-sync check, the launches and
    CUDA activities per step at B = 1 and B = 8, aggregate scans/s at
    B = 1, 8, 32 beside replay_odometry's, and the kernels at the batched
    shapes."""
    import torch
    from lis_slam_torch.parallel import batched
    from lis_slam_torch.pipeline import driver, odometry, trajectory

    starts = _lane_starts(BATCH_LANES, len(scans))
    seqs = [scans[s:s + BATCH_SCANS] for s in starts]
    counts, results = {}, {}
    for backend in ("pallas", "xla"):
        c = _batched_cfg(cfg, backend)
        _zero_launches()
        torch.cuda.synchronize()
        t = time.perf_counter()
        poses = batched.replay_batched(seqs, c, device=dev)
        wall = time.perf_counter() - t
        counts[f"batched_{backend}"] = _launches()
        check(poses.shape == (BATCH_LANES, BATCH_SCANS, 6)
              and bool(np.all(np.isfinite(poses))),
              f"batched {backend}: poses not finite (B, N, 6)")
        check(bool(np.array_equal(poses[0], poses[1])),
              f"batched {backend}: lanes 0 and 1 differ")
        ates = [trajectory.ate_rmse(
            poses[b], trajectory.relative_to_first(gt[s:s + BATCH_SCANS]),
            align=False) for b, s in enumerate(starts)]
        log("batched", f"gn_backend={backend}: B {BATCH_LANES} x "
            f"{BATCH_SCANS} scans in {wall:.3f} s (first call included), "
            f"lanes 0/1 bit-equal, ATE per lane (m) "
            f"{[round(a, 4) for a in ates]}, K1 launches "
            f"{counts[f'batched_{backend}'][0]}, K2 "
            f"{counts[f'batched_{backend}'][1]}, K3 "
            f"{counts[f'batched_{backend}'][2]}")
        check(max(ates) < ATE_MAX, f"batched {backend}: ATE {max(ates)}")
        results[backend] = dict(poses=poses.tolist(), ate=ates)
        if BASELINE is not None:
            results[backend]["baseline"] = _baseline_lanes(seqs, c, dev,
                                                           poses, backend)
    k1, k2, k3 = counts["batched_pallas"]
    check(k1 > 0 and k2 > 0 and k3 > 0
          and counts["batched_xla"][0] > 0 and counts["batched_xla"][1] == 0
          and counts["batched_xla"][2] > 0,
          f"batched: launches {counts}")

    # lane 0 with a keyframe merge on every scan against the port's own
    # single-sequence uniform step, and odom_step on the same scans
    c1 = _batched_cfg(cfg, "pallas", kf_every=1)
    p1 = batched.replay_batched(seqs[:2], c1, device=dev)
    state = odometry.init_state(c1, dev)
    uni = []
    for s in seqs[0]:
        state, out = odometry.odom_step_uniform(state, s, c1)
        uni.append(out.pose)
    uni = torch.stack(uni).cpu().numpy()
    gap = float(np.linalg.norm(p1[0][:, 3:] - uni[:, 3:], axis=1).max())
    gt0 = trajectory.relative_to_first(gt[:BATCH_SCANS])
    cp = _batched_cfg(cfg, "pallas")
    res = driver.replay_odometry(seqs[0], cp, warmup=BATCH_RATE_WARMUP,
                                 device=dev)
    ate_step = trajectory.ate_rmse(res.poses, gt0, align=False)
    ate_uni = trajectory.ate_rmse(uni, gt0, align=False)
    log("batched", f"kf every scan: lane 0 vs odom_step_uniform max "
        f"position gap {gap:.6f} m (bar {BATCH_SINGLE_ATOL}); ATE on lane "
        f"0's {BATCH_SCANS} scans: uniform step {ate_uni:.4f} m, batched (kf every "
        f"{cfg.runtime.batched_kf_every}) {results['pallas']['ate'][0]:.4f} "
        f"m, odom_step {ate_step:.4f} m")
    check(gap < BATCH_SINGLE_ATOL, f"batched: lane 0 off the uniform step "
          f"by {gap} m")
    last = BATCH_LANES - 1
    alone = batched.replay_batched([seqs[last]], cp, device=dev)[0]
    gap_last = float(np.abs(alone - np.asarray(
        results["pallas"]["poses"][last])).max())
    log("batched", f"lane {last} replayed alone (B 1) vs in the B "
        f"{BATCH_LANES} batch (pallas): max |pose difference| {gap_last}")

    n_sync = _check_no_syncs(scans, cp)
    log("batched", f"0 host syncs in {n_sync} warm batched_odom_step calls "
        f"(B {BATCH_LANES}, a merge step and a merge-free step) under "
        f"torch.cuda.set_sync_debug_mode('error')")

    per_b, busy_b = {}, {}
    for lanes in (1, BATCH_LANES):
        names, launches, busy, wall, ops, totals = _step_kernels(
            scans, cp, lanes)
        per_b[lanes] = (names, launches)
        busy_b[lanes] = dict(busy_ms=busy, wall_ms=wall)
        log("batched", f"B {lanes}: one merge step launches K1 "
            f"{launches[0]}, K2 {launches[1]}, K3 {launches[2]}, CUDA "
            f"activities {sum(names.values())} ({len(names)} kinds; "
            f"traced windows {totals}), aten ops {ops}; device busy "
            f"{busy:.3f} ms of {wall:.3f} ms wall ({busy / wall:.3f} busy "
            "share, profiler on)")
        if BASELINE is not None:
            _n, l_b, busy, wall, _o, _t = _step_kernels(
                scans, cp, lanes, pkg=BASELINE.pkg)
            busy_b[lanes].update(baseline_busy_ms=busy, baseline_wall_ms=wall)
            log("batched", f"B {lanes} baseline: one merge step launches "
                f"K1/K2/K3 {l_b}; device busy {busy:.3f} ms of {wall:.3f} "
                f"ms wall ({busy / wall:.3f} busy share, profiler on)")
    (n1, l1), (n8, l8) = per_b[1], per_b[BATCH_LANES]
    diff = {k: (n1.get(k, 0), n8.get(k, 0)) for k in set(n1) | set(n8)
            if n1.get(k, 0) != n8.get(k, 0)}
    check(l1 == l8, f"batched: kernel launches per step differ, B 1 {l1} vs "
          f"B {BATCH_LANES} {l8}")
    check(sum(n1.values()) == sum(n8.values()),
          f"batched: CUDA activities per step differ: {diff}")
    log("batched", f"launches per step equal at B 1 and B {BATCH_LANES}: "
        f"K1/K2/K3 {l1}, CUDA activities {sum(n1.values())}"
        + (f" (kinds differ: {diff})" if diff else ""))

    rates = {}
    for lanes in BATCH_RATE_LANES:
        if BASELINE is None:
            rates[lanes] = _rate(scans, cp, lanes)
        else:  # in turns, BATCH_RATE_TURNS times: baseline, this, this,
            # baseline (the host is shared: one turn's pairs vary by 15%)
            runs, base_runs, peak = [], [], 0
            for _ in range(BATCH_RATE_TURNS):
                base_runs.append(_rate(scans, cp, lanes, BASELINE.pkg)[0])
                for _ in range(2):
                    rate, mem = _rate(scans, cp, lanes)
                    runs.append(rate)
                    peak = max(peak, mem)
                base_runs.append(_rate(scans, cp, lanes, BASELINE.pkg)[0])
            rates[lanes] = (float(np.median(runs)), peak,
                            dict(runs=runs, baseline_runs=base_runs))
            log("batched", f"B {lanes} baseline: "
                f"{float(np.median(base_runs)):.3f} aggregate scans/s "
                f"(median; runs {[round(r, 3) for r in base_runs]}); this "
                f"checkout's runs {[round(r, 3) for r in runs]}")
        log("batched", f"B {lanes}: {rates[lanes][0]:.3f} aggregate scans/s "
            f"{'(median) ' if BASELINE is not None else ''}"
            f"({BATCH_RATE_STEPS} steps on the kf-every-"
            f"{cp.runtime.batched_kf_every} cadence), peak device memory "
            f"{rates[lanes][1]} bytes")
    res_rate = driver.replay_odometry(scans[:BATCH_SCANS], cp,
                                      warmup=BATCH_RATE_WARMUP, device=dev)
    log("batched", f"replay_odometry (odom_step, pallas) in the same call: "
        f"{res_rate.scans_per_sec:.3f} scans/s; B {BATCH_LANES} / "
        f"replay_odometry = "
        f"{rates[BATCH_LANES][0] / res_rate.scans_per_sec:.3f}")

    # K3 on the normal equations of a warm step at each rate's lanes
    k3_err = 0.0
    for lanes in K3_RATE_LANES:
        calls, states, scan_b = _record_k3_lanes(scans, cp, lanes)
        k3_err = max(k3_err, _check_k3(calls, cfg, "batched",
                                       host=lanes == BATCH_LANES))
        if lanes == BATCH_LANES:
            _check_batched_kernels(states, scan_b, cp)
    with open(os.path.join(out_dir, "batched.json"), "w") as f:
        json.dump(dict(results=results, single_gap_m=gap,
                       ate_uniform=ate_uni, ate_odom_step=ate_step,
                       rates={str(b): r for b, r in rates.items()},
                       busy={str(b): v for b, v in busy_b.items()},
                       replay_odometry_scans_per_sec=res_rate.scans_per_sec,
                       kernels_per_step={str(b): dict(names=v[0],
                                                      launches=v[1])
                                         for b, v in per_b.items()}), f)
    return counts, k3_err


def _baseline_lanes(seqs, cfg, dev, poses, backend):
    """--baseline's replay_batched of the same lanes and config: each
    lane's final position against this checkout's (m), the largest
    |pose difference| over the run, the baseline's wall s."""
    import torch

    batched = _pkg_mod(BASELINE.pkg, "parallel.batched")
    scan_type = _pkg_mod(BASELINE.pkg, "pipeline.odometry").ScanInput
    seqs = [[scan_type(*s) for s in seq] for seq in seqs]  # its own type
    torch.cuda.synchronize()
    t = time.perf_counter()
    base = batched.replay_batched(seqs, cfg, device=dev)
    wall = time.perf_counter() - t
    final = np.linalg.norm(poses[:, -1, 3:] - base[:, -1, 3:], axis=1)
    res = dict(final_gap_m=final.tolist(),
               max_pose_diff=float(np.abs(poses - base).max()), wall_s=wall)
    log("batched", f"gn_backend={backend}: baseline replay in {wall:.3f} s; "
        f"final position per lane vs this checkout (m) "
        f"{[float(f'{x:.3g}') for x in final]}, max |pose difference| over "
        f"the run {res['max_pose_diff']:.3g}")
    return res


# ---------------------------------------------------------------------------
# sharded: the multi-device layer (parallel/mesh.py) on the one card
# ---------------------------------------------------------------------------

SHARD_RANKS = 2  # ranks sharing the card over gloo
SHARD_GAP_M = 5e-3  # a lane vs the unsharded replay (tests/test_parallel.py:266)
# one float32 step on a mesh vs the unsharded step (tests/test_torch_seg_train.py)
SHARD_LOSS_RTOL = 1e-5
SHARD_NORM_RTOL = 1e-4
SHARD_GRAD_RTOL = 5e-3  # the gradients, global
SHARD_PARAM_ATOL_LR = 2e-3  # x lr, where |grad| > 5% of its leaf's largest
# ... and above this (1000 x Adam's eps, where the first step is lr sign(g)
# to 0.1%): below it, in the deep leaves at full width, the float32
# gradient is mostly rounding, and Adam's step turns on it (the float64
# step, held to 1e-6 a leaf, shows the sharding itself exact)
SHARD_GRAD_CLEAR = 1e-5
SHARD_ADAM_ATOL_LR = 1e-4  # x lr: the step is Adam's on its own gradients
SHARD_F64_RTOL = 1e-6  # float64: loss, grad norm, every gradient leaf
SHARD_BF16_STEPS = 5
# (model_parallel, spatial_parallel) of each mesh over the spawn's world
SHARD_MESHES = {1: ((1, 1),), 2: ((1, 1), (2, 1), (1, 2))}
DRYRUN_REPEATS = 3  # dryrun_multichip(4) calls, bit-identical results
# (kind, input shape, kernel shape, padding) of RangeNet's narrowest bf16
# convolutions: the encoder's stride-(1, 2) 3 x 3 conv as _conv_sharded
# calls it (one output column at widths 3 and 4, where torch's CPU bf16
# kernel reads unwritten memory) and the decoder's transposed conv on 1
# local column with its halo (padding 3) and on 2 columns (padding 1)
NARROW_CONVS = tuple(("conv", (1, 48, 66, w), (64, 48, 3, 3), (0, 0))
                     for w in (3, 4, 8, 64)) + tuple(
    ("deconv", (1, 128, 64, w), (128, 48, 1, 4), (0, p))
    for w, p in ((3, 3), (2, 1)))
NARROW_ZERO_CALLS = 20  # zero-input calls a shape, each after a random one


def _train_inputs(full):
    """The train phase's batch (numpy): TRAIN_BATCH seeded normal images,
    seeded labels, every pixel valid."""
    r = np.random.default_rng(0)
    shape = (TRAIN_BATCH, full.model_input_h, full.model_input_w)
    return (r.normal(size=shape + (full.model_input_c,)).astype(np.float32),
            r.integers(0, full.num_classes, shape).astype(np.int32),
            np.ones(shape, bool))


def _train_reference(cfg, variables, batch, dev):
    """The unsharded port step from `variables` (float32): loss, grad
    norm, and the parameters after it and the gradients, on the host."""
    import torch
    from lis_slam_torch.train import seg_train

    model, opt = seg_train.create_train_state(cfg, None, lr=TRAIN_LR,
                                              device=dev, variables=variables)
    m = seg_train.make_train_step(model, opt)(
        *(torch.as_tensor(a, device=dev) for a in batch))
    ref = dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
               params={n: p.detach().cpu() for n, p in
                       model.named_parameters()},
               grads={n: p.grad.cpu() for n, p in model.named_parameters()})
    del model, opt
    torch.cuda.empty_cache()
    return ref


def _train_gaps(res, ref, cfg, start):
    """A sharded float32 step (seg_train.train_sharded's result) against
    the unsharded one: loss and grad norm relative gaps, the gradients'
    global relative gap; the largest gap over lr between the parameters
    after the step and Adam's first step on the sharded gradients from
    `start`, over every entry; the largest parameter gap over lr to the
    unsharded step where the gradient is above 5% of its leaf's largest
    entry and above SHARD_GRAD_CLEAR (with its leaf and the share of
    entries so held), and the largest over the other entries above 5%."""
    from lis_slam_torch.semantic import weights as W

    after = W.to_torch_state(res["variables"], cfg)
    worst, leaf, held, total, d2, g2, low, adam = (0.0, None, 0, 0, 0.0,
                                                   0.0, 0.0, 0.0)
    for n, p in ref["params"].items():
        g, gs = ref["grads"][n], res["grads"][n]
        d2 += float(((gs - g) ** 2).sum())
        g2 += float((g ** 2).sum())
        own = start[n] - TRAIN_LR * gs / (gs.abs() + 1e-8)
        adam = max(adam, float((after[n] - own).abs().max()) / TRAIN_LR)
        gap = (after[n] - p).abs() / TRAIN_LR
        above = g.abs() > 0.05 * g.abs().max()
        clear = above & (g.abs() > SHARD_GRAD_CLEAR)
        if clear.any() and float(gap[clear].max()) > worst:
            worst, leaf = float(gap[clear].max()), n
        if (above & ~clear).any():
            low = max(low, float(gap[above & ~clear].max()))
        held += int(clear.sum())
        total += p.numel()
    return dict(loss_rel=abs(res["losses"][0] - ref["loss"]) / ref["loss"],
                norm_rel=abs(res["grad_norms"][0] - ref["grad_norm"])
                / ref["grad_norm"], grad_rel=(d2 / g2) ** 0.5,
                adam_gap_lr=adam, param_gap_lr=worst, param_gap_leaf=leaf,
                held=held / total, small_gap_lr=low)


def _step64(mesh, cfg, variables, batch, dev):
    """One float64 sharded training step of a float64 RangeNet (mesh
    None: the world of one, no collective): loss, grad norm and every
    gradient, whole, on the host."""
    import torch
    from lis_slam_torch.models import rangenet
    from lis_slam_torch.parallel import mesh as pmesh
    from lis_slam_torch.semantic import weights as W
    from lis_slam_torch.train import seg_train

    model = rangenet.RangeNet(
        num_classes=cfg.num_classes, in_features=cfg.model_input_c,
        dtype=torch.float64, enc_blocks=cfg.enc_blocks,
        enc_widths=cfg.enc_widths, dec_widths=cfg.dec_widths,
        param_dtype=torch.float64).double()
    model.load_state_dict(W.to_torch_state(variables, cfg))
    model = model.to(dev).train()
    opt = torch.optim.Adam(model.parameters(), lr=TRAIN_LR)
    step, shard_state, _ = seg_train.make_sharded_train_step(model, opt, mesh)
    shard_state(model, opt)
    img, pl = pmesh.shard_images(mesh), pmesh.shard_planes(mesh)
    images, labels, mask = (torch.as_tensor(a) for a in batch)
    out = step(img(images).to(dev, torch.float64), pl(labels).to(dev),
               pl(mask).to(dev))
    grads = {n: shard_state.placements[n].gather(p.grad).cpu()
             for n, p in model.named_parameters()}
    res = float(out["loss"]), float(out["grad_norm"]), grads
    del model, opt, step
    torch.cuda.empty_cache()
    return res


def _gaps64(res, ref):
    """A float64 sharded step against the world of one: loss and grad norm
    relative gaps, the largest gradient gap over its leaf's largest entry
    and that leaf."""
    (loss, norm, grads), (l1, n1, g1) = res, ref
    worst = max((float((grads[k] - g).abs().max() / g.abs().max()), k)
                for k, g in g1.items())
    return dict(loss_rel=abs(loss - l1) / l1, norm_rel=abs(norm - n1) / n1,
                leaf_rel=worst[0], leaf=worst[1])


def _shard_rank(rank, mesh, clouds, cfg):
    """One rank of the sharded phase (a parallel/mesh.spawn function):
    replay_batched over the mesh (the batched phase's 8 lanes of
    BATCH_SCANS circuit scans), its K1/K2/K3 launches; on a world of one
    also the unsharded replay in this process; the lanes' step under
    sync debug mode "error"; K1/K2 against their plain versions at this
    rank's shapes, one rank at a time; then make_sharded_train_step at
    the full darknet53 width on each mesh of SHARD_MESHES: one float32
    step held to the unsharded step (computed here on rank 0) and
    SHARD_BF16_STEPS bf16 steps. Returns rank 0's view; launches and
    errors of every rank."""
    import dataclasses

    import torch
    import torch.distributed as dist
    from lis_slam_torch.config import SemanticConfig
    from lis_slam_torch.models import rangenet
    from lis_slam_torch.parallel import batched
    from lis_slam_torch.parallel import mesh as pmesh
    from lis_slam_torch.pipeline import odometry
    from lis_slam_torch.semantic import weights as W
    from lis_slam_torch.train import seg_train

    dev = torch.device("cuda", torch.cuda.current_device())
    world = mesh.size()
    scans = [odometry.ScanInput(points=torch.as_tensor(p, device=dev),
                                valid=torch.as_tensor(v, device=dev))
             for p, v in clouds]
    starts = _lane_starts(BATCH_LANES, len(scans))
    seqs = [scans[s:s + BATCH_SCANS] for s in starts]
    out = {}
    _zero_launches()
    torch.cuda.synchronize()
    t = time.perf_counter()
    poses = batched.replay_batched(seqs, cfg, mesh=mesh, device=dev)
    out["wall_s"] = time.perf_counter() - t
    counts = _launches()
    out["poses"] = poses
    if world == 1:
        out["unsharded"] = batched.replay_batched(seqs, cfg, device=dev)

    # this rank's lanes: the step without a host sync, then K1/K2 at its
    # shapes against their plain versions (ranks in turn: one card)
    step, shard, _ = batched.make_sharded_step(cfg, mesh)
    lanes = BATCH_LANES // pmesh.axis(mesh, "data").size
    mine = shard(torch.as_tensor(starts)).tolist()
    stacked = [batched.stack_scans([scans[s + i] for s in mine])
               for i in range(4)]
    states = batched.batched_init_state(cfg, lanes, dev)
    kf_every = max(1, cfg.runtime.batched_kf_every)
    for i in range(3):
        states, _ = step(states, stacked[i], allow_kf=(i % kf_every == 0))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        step(states, stacked[3], allow_kf=False)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    errs = None
    for r in range(world):
        if r == rank:
            path = f"sharded w{world} r{rank}"
            errs = _check_batched_kernels(states, stacked[3], cfg, path=path)
            calls = _record_k3(lambda: step(states, stacked[3],
                                            allow_kf=False))
            _check_k3(calls, cfg, path)
        if world > 1:
            dist.barrier()
    every = [None] * world
    if world > 1:
        dist.all_gather_object(every, (counts, errs))
    else:
        every = [(counts, errs)]
    out["launches"] = [c for c, _e in every]
    out["k2_err"] = max(e for _c, e in every)
    out["cases"] = {k: [c for c in CASES[k] if c["path"].startswith(
        "sharded")] for k in ("K1", "K2", "K3")}
    del scans, seqs, stacked, states
    torch.cuda.empty_cache()

    full = SemanticConfig(enabled=True)
    f32 = dataclasses.replace(full, fp16=False)
    variables = rangenet.init_params(full, torch.Generator().manual_seed(0))
    batch = _train_inputs(full)
    ref = _train_reference(f32, variables, batch, dev) if rank == 0 else None
    ref64 = _step64(None, f32, variables, batch, dev) if rank == 0 else None
    start = W.to_torch_state(variables, f32)
    out["train"] = {}
    for mp, sp in SHARD_MESHES[world]:
        r32 = seg_train.train_sharded(rank, mesh, f32, variables, *batch,
                                      lr=TRAIN_LR, steps=1, model_parallel=mp,
                                      spatial_parallel=sp)
        gaps = _train_gaps(r32, ref, f32, start) if rank == 0 else None
        del r32
        r64 = _step64(pmesh.make_mesh(world, mp, sp, device="cuda"), f32,
                      variables, batch, dev)
        gaps64 = _gaps64(r64, ref64) if rank == 0 else None
        del r64
        r16 = seg_train.train_sharded(rank, mesh, full, variables, *batch,
                                      lr=TRAIN_LR, steps=SHARD_BF16_STEPS,
                                      model_parallel=mp, spatial_parallel=sp)
        out["train"][(mp, sp)] = dict(
            mesh=dict(data=world // (mp * sp), model=mp, space=sp), f32=gaps,
            f64=gaps64,
            losses=r16["losses"], step_ms=r16["step_ms"],
            peak_bytes=r16["peak_bytes"])
        del r16
        torch.cuda.empty_cache()
    return out


def _narrow_convs(dev):
    """cuDNN's bf16 F.conv2d / F.conv_transpose2d at NARROW_CONVS: exact
    zeros on a zero input in each of NARROW_ZERO_CALLS calls (each after a
    call on random inputs, so the allocator hands back written memory);
    on random inputs within one bf16 ulp of the float32 convolution
    rounded once to bf16 (the port's CPU path, rangenet._conv), the ulp
    taken at the sum of the magnitudes of each value's terms; and the
    port's _conv on the card is cuDNN's call, bit for bit. Returns one
    row a shape."""
    import torch
    import torch.nn.functional as F
    from lis_slam_torch.models import rangenet as rn

    r = np.random.default_rng(7)
    rows = []
    for kind, xs, ws, pad in NARROW_CONVS:
        transposed = kind == "deconv"
        conv = F.conv_transpose2d if transposed else F.conv2d
        x = torch.from_numpy(r.normal(size=xs).astype(np.float32)).bfloat16()
        w = torch.from_numpy((r.normal(size=ws) / np.sqrt(np.prod(ws[1:])))
                             .astype(np.float32)).bfloat16()
        xd, wd = x.to(dev), w.to(dev)
        zero = torch.zeros_like(xd)
        nonzero = 0
        for _ in range(NARROW_ZERO_CALLS):
            y = conv(xd, wd, None, (1, 2), pad)
            nonzero += int(torch.count_nonzero(conv(zero, wd, None, (1, 2),
                                                    pad)))
        same = torch.equal(rn._conv(xd, wd, None, (1, 2), pad, transposed),
                           y)
        ref = rn._conv(x, w, None, (1, 2), pad, transposed)
        mags = conv(x.double().abs(), w.double().abs(), None, (1, 2),
                    pad).numpy()
        _, e = np.frexp(mags)
        ulp = np.where(mags > 0, np.ldexp(1.0, e - 8), 0.0)
        got = y.cpu()
        err = (got.double() - ref.double()).abs().numpy()
        rows.append(dict(kind=kind, x=list(xs), out_w=int(got.shape[3]),
                         zero_nonzero=nonzero, port_is_cudnn=same,
                         over_ulp=int((err > ulp).sum()),
                         max_err_ulps=float((err / np.maximum(ulp, 1e-300))
                                            .max()),
                         bit_equal=float((got == ref).float().mean())))
        check(got.shape == ref.shape and nonzero == 0 and same
              and rows[-1]["over_ulp"] == 0,
              f"sharded: cuDNN's bf16 {kind} at {xs} pad {pad}: {rows[-1]}")
    return rows


def phase_sharded(clouds, gt, cfg, dev, out_dir):
    """The multi-device layer on the one card: (a) a world of one on NCCL,
    (b) + (c) two ranks sharing the card over gloo, (d) the port's
    dryrun_multichip(4) over gloo. Returns the kernels' launches per path
    and rank, K2's largest error at the sharded shapes, and the ranks'
    kernel cases."""
    import torch
    from lis_slam_torch import entry
    from lis_slam_torch.parallel import mesh as pmesh
    from lis_slam_torch.pipeline import trajectory

    cp = _batched_cfg(cfg, "pallas")
    starts = _lane_starts(BATCH_LANES, len(clouds))
    torch.cuda.empty_cache()
    t = time.perf_counter()
    w1 = pmesh.spawn(1, _shard_rank, clouds, cp, backend="nccl", device=dev)
    t1 = time.perf_counter() - t
    check(np.array_equal(w1["poses"], w1["unsharded"]),
          "sharded: the world of one differs from the unsharded replay")
    log("sharded", f"(a) world 1 over nccl: replay_batched(mesh=make_mesh(1))"
        f" B {BATCH_LANES} x {BATCH_SCANS} bit-equal to replay_batched("
        f"mesh=None) in the same rank; replay {w1['wall_s']:.3f} s (first "
        f"call included), K1/K2/K3 launches {w1['launches'][0]}; spawn "
        f"{t1:.1f} s in all")
    t = time.perf_counter()
    w2 = pmesh.spawn(SHARD_RANKS, _shard_rank, clouds, cp, backend="gloo",
                     device=dev)
    t2 = time.perf_counter() - t
    poses, ref = w2["poses"], w1["unsharded"]
    check(poses.shape == (BATCH_LANES, BATCH_SCANS, 6)
          and bool(np.all(np.isfinite(poses))),
          "sharded: poses not finite (B, N, 6)")
    check(bool(np.array_equal(poses[0], poses[1])),
          "sharded: lanes 0 and 1 differ")
    gap = float(np.linalg.norm(poses[..., 3:] - ref[..., 3:], axis=-1).max())
    ates = [trajectory.ate_rmse(
        poses[b], trajectory.relative_to_first(gt[s:s + BATCH_SCANS]),
        align=False) for b, s in enumerate(starts)]
    log("sharded", f"(b) {SHARD_RANKS} ranks on the card over gloo, "
        f"{BATCH_LANES // SHARD_RANKS} lanes a rank: lanes 0/1 bit-equal, "
        f"max position gap to the unsharded replay {gap:.3g} m (bar "
        f"{SHARD_GAP_M}), max |pose difference| "
        f"{float(np.abs(poses - ref).max())}, ATE per lane (m) "
        f"{[round(a, 4) for a in ates]}; K1/K2/K3 launches per rank "
        f"{w2['launches']}; replay {w2['wall_s']:.3f} s on rank 0; K2 at the "
        f"ranks' shapes within {w2['k2_err']:.3g} scaled; spawn {t2:.1f} s")
    check(gap < SHARD_GAP_M, f"sharded: a lane {gap} m off the unsharded")
    check(max(ates) < ATE_MAX, f"sharded: ATE {max(ates)}")
    for res in (w1, w2):
        for r, c in enumerate(res["launches"]):
            check(all(x > 0 for x in c), f"sharded: rank {r} of "
                  f"{len(res['launches'])} launched K1/K2/K3 {c}")
    meshes = [(world, tr) for world, res in ((1, w1), (SHARD_RANKS, w2))
              for tr in res["train"].values()]
    for world, tr in meshes:
        g = tr["f32"]
        log("sharded", f"(c) world {world} mesh {tr['mesh']}: f32 step "
            f"vs unsharded: loss {g['loss_rel']:.3g} rel, grad norm "
            f"{g['norm_rel']:.3g} rel, gradients {g['grad_rel']:.3g} "
            f"rel (global), Adam on its own gradients within "
            f"{g['adam_gap_lr']:.3g} x lr, params {g['param_gap_lr']:.3g} "
            f"x lr on "
            f"{g['held']:.3f} of the entries (the largest in "
            f"{g['param_gap_leaf']}; where |g| <= {SHARD_GRAD_CLEAR} "
            f"{g['small_gap_lr']:.3g} x lr); f64 "
            f"step vs the world of one: loss {tr['f64']['loss_rel']:.3g}, "
            f"grad norm {tr['f64']['norm_rel']:.3g}, every leaf within "
            f"{tr['f64']['leaf_rel']:.3g} of its largest "
            f"({tr['f64']['leaf']}); bf16 losses "
            f"{', '.join(f'{x:.4f}' for x in tr['losses'])}; ms a step "
            f"(CUDA events, rank 0) "
            f"{', '.join(f'{x:.2f}' for x in tr['step_ms'])}; peak "
            f"device memory per rank {tr['peak_bytes']} bytes")
    for world, tr in meshes:
        g = tr["f32"]
        check(g["loss_rel"] <= SHARD_LOSS_RTOL
              and g["norm_rel"] <= SHARD_NORM_RTOL
              and g["grad_rel"] <= SHARD_GRAD_RTOL
              and g["param_gap_lr"] <= SHARD_PARAM_ATOL_LR
              and g["adam_gap_lr"] <= SHARD_ADAM_ATOL_LR,
              f"sharded: world {world} mesh {tr['mesh']} f32 step {g}")
        g64 = tr["f64"]
        check(max(g64["loss_rel"], g64["norm_rel"], g64["leaf_rel"])
              <= SHARD_F64_RTOL,
              f"sharded: world {world} mesh {tr['mesh']} f64 step {g64}")
        check(bool(np.isfinite(tr["losses"]).all())
              and tr["losses"][-1] < tr["losses"][0],
              f"sharded: bf16 loss did not fall ({tr['losses']})")
    dries, walls = [], []
    for _ in range(DRYRUN_REPEATS):
        t = time.perf_counter()
        dries.append(entry.dryrun_multichip(4, device=dev, backend="gloo"))
        walls.append(time.perf_counter() - t)
    dry = dries[0]
    log("sharded", f"(d) dryrun_multichip(4) over gloo on the card, "
        f"{DRYRUN_REPEATS} calls: mesh {dry['mesh']}, losses "
        f"{[d['loss'] for d in dries]}, poses (4, 6) finite; "
        f"{', '.join(f'{x:.1f}' for x in walls)} s")
    check(all(d["loss"] == dry["loss"]
              and d["poses"].tobytes() == dry["poses"].tobytes()
              for d in dries),
          "sharded: dryrun_multichip(4) calls differ: "
          f"{[(d['loss'], d['poses'].tolist()) for d in dries]}")
    narrow = _narrow_convs(dev)
    for row in narrow:
        log("sharded", f"(e) cuDNN bf16 {row['kind']} input {row['x']} -> "
            f"{row['out_w']} columns: zero input {row['zero_nonzero']} "
            f"nonzero values in {NARROW_ZERO_CALLS} calls; random input "
            f"within {row['max_err_ulps']:.3g} bf16 ulp of the float32 conv "
            f"rounded once ({row['bit_equal']:.4f} bit-equal), the port's "
            f"_conv is cuDNN's call: {row['port_is_cudnn']}")
    with open(os.path.join(out_dir, "sharded.json"), "w") as f:
        json.dump(dict(gap_m=gap, ate=ates, launches_w1=w1["launches"],
                       launches_w2=w2["launches"],
                       train={f"w{w} {k}": v for w, res in
                              ((1, w1), (SHARD_RANKS, w2))
                              for k, v in res["train"].items()},
                       dryrun_losses=[d["loss"] for d in dries],
                       narrow_convs=narrow), f, default=str)
    launches = {"sharded_w1_r0": tuple(w1["launches"][0])}
    launches.update({f"sharded_w{SHARD_RANKS}_r{r}": tuple(c)
                     for r, c in enumerate(w2["launches"])})
    for res in (w1, w2):
        for k in ("K1", "K2", "K3"):
            CASES[k].extend(res["cases"][k])
    return launches, max(w1["k2_err"], w2["k2_err"])


def _load_baseline(root: str, name: str = "lis_slam_torch_baseline"):
    """The lis_slam_torch package under `root`, imported as `name` so both
    checkouts live in one process, with its K1/K2/K3 built into its own
    _build directory: a namespace of pkg (the name), knn_cuda, gn_cuda,
    gn_solve, cuda_build and usage (its K3's ptxas lines)."""
    import importlib
    import importlib.util
    import types

    pkg = os.path.join(os.path.abspath(root), "lis_slam_torch")
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    base = types.SimpleNamespace(pkg=name, **{
        m: importlib.import_module(f"{name}.ops.{m}")
        for m in ("knn_cuda", "gn_cuda", "gn_solve", "cuda_build")})
    t = time.perf_counter()
    base.knn_cuda._lib()
    base.gn_cuda._lib()
    base.gn_solve._lib()
    base.usage = _ptxas_usage(base.cuda_build.build_log(
        "gn_solve", base.gn_solve._FLAGS))
    log("build", f"baseline {root}: K1/K2/K3 built in "
        f"{time.perf_counter() - t:.2f} s; its gn_solve.cu ptxas: "
        + base.usage)
    return base


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scans", type=int, default=60)
    ap.add_argument("--out", default=os.path.join(ROOT, "smoke_out"),
                    help="directory for build logs and per-scan results")
    ap.add_argument("--baseline", default=None,
                    help="root of another checkout (e.g. the parent commit, "
                         "unpacked): its K1/K2/K3 are built from there and "
                         "timed in turns with this checkout's on the same "
                         "inputs, and its batched replay is run beside "
                         "this one's")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    try:
        import torch  # noqa: F401
        import lis_slam_torch  # noqa: F401
    except ImportError as e:
        print(f"FAIL: {e} (run from a checkout of the repository)",
              file=sys.stderr)
        return 1
    phase, t_phase = "device", time.perf_counter()

    def begin(name):
        """Log the finished phase's wall seconds; return `name`."""
        nonlocal t_phase
        now = time.perf_counter()
        log("time", f"{phase} {now - t_phase:.1f} s")
        t_phase = now
        return name

    try:
        card = phase_device()
        os.makedirs(args.out, exist_ok=True)
        phase = begin("build")
        phase_build(args.out)
        if args.baseline:
            global BASELINE
            BASELINE = _load_baseline(args.baseline)

        phase = begin("data")
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

        phase = begin("K1")
        k1 = phase_k1(inp, dev)
        phase = begin("K2")
        k2 = phase_k2(inp, cfg, dev)
        del inp
        phase = begin("projection")
        phase_projection(dev, args.out)
        phase = begin("main")
        launches, vec_poses, k3_main = phase_main(scans, gt, cfg, dev,
                                                  args.out)
        phase = begin("lio")
        launches.update(phase_lio(dev, args.out))
        phase = begin("greedy")
        launches.update(phase_greedy(scans, gt, cfg, dev, vec_poses))
        phase = begin("batched")
        batched_launches, k3 = phase_batched(scans, gt, cfg, dev, args.out)
        k3 = max(k3, k3_main)
        launches.update(batched_launches)
        clouds = [(c.points.cpu().numpy(), c.valid.cpu().numpy())
                  for c in scans]
        del scans
        phase = begin("slam")
        slam_launches, (k1_slam, k2_slam), plaza = phase_slam(dev, args.out)
        launches.update(slam_launches)
        k1, k2 = max(k1, k1_slam), max(k2, k2_slam)
        phase = begin("semantic")
        darknet = phase_semantic(dev, args.out)
        phase = begin("slam_infer")
        launches.update(phase_slam_infer(*plaza, darknet, dev, args.out))
        del darknet
        phase = begin("lio_slam")
        lio_launches, (k1_lio, k2_lio) = phase_lio_slam(*plaza, dev, args.out)
        launches.update(lio_launches)
        k1, k2 = max(k1, k1_lio), max(k2, k2_lio)
        phase = begin("cli")
        cli_launches, (k1_cli, k2_cli) = phase_cli(card, dev, args.out)
        launches.update(cli_launches)
        k1, k2 = max(k1, k1_cli), max(k2, k2_cli)
        phase = begin("checkpoint")
        resumed_from = phase_checkpoint(*plaza, dev, args.out)
        del plaza
        # a process of its own: after several million launches in one
        # process, torch.profiler's windows lose K2's device records (the
        # recipe phase's, and this phase's kernel check when it ran here)
        phase = begin("endurance")
        ctx = torch.multiprocessing.get_context("spawn")
        with ctx.Pool(1) as pool:
            end_launches, (k1_end, k2_end), end_cases = pool.apply(
                _endurance_child, (args.out,))
        for key, cases in end_cases.items():
            CASES[key].extend(cases)
        launches.update(end_launches)
        k1, k2 = max(k1, k1_end), max(k2, k2_end)
        phase = begin("ndt")
        phase_ndt(resumed_from, dev, args.out)
        del resumed_from
        phase = begin("train")
        phase_train(dev, args.out)
        phase = begin("sharded")
        sharded_launches, k2_shard = phase_sharded(clouds, gt, cfg, dev,
                                                   args.out)
        launches.update(sharded_launches)
        k2 = max(k2, k2_shard)
        # last: after ~5 million launches of the recipe's training, this
        # process's later torch.profiler windows lost K2's device records
        phase = begin("recipe")
        launches.update(phase_recipe(dev, args.out))
        begin(None)
        with open(os.path.join(args.out, "kernel_cases.json"), "w") as f:
            json.dump({"card": card, "cases": CASES}, f, indent=1)
    except BaseException as e:  # any failure: report and exit nonzero
        if isinstance(e, SystemExit) and isinstance(e.code, str):
            print(f"FAIL [{phase}]: {e.code}", file=sys.stderr)
        else:
            traceback.print_exc()
            print(f"FAIL [{phase}]: {e!r}", file=sys.stderr)
        return 1
    kernels = []
    for j, (key, name, source, replaces, err, path) in enumerate((
            ("K1", "K1 exact kNN", K1_SOURCE, K1_REPLACES, k1, "main"),
            ("K2", "K2 fused GN accumulation", K2_SOURCE, K2_REPLACES, k2,
             "main"),
            ("K3", "K3 GN solve and masked update", K3_SOURCE, K3_REPLACES,
             k3, "batched"))):
        per_path = {p: c[j] for p, c in launches.items() if len(c) > j}
        # the headline numbers: the largest case of the kernel's main path
        top = max((c for c in CASES[key] if c["path"] == path),
                  key=lambda c: c["bound_ms"])
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=sum(per_path.values()), launches_per_path=per_path,
            max_abs_err=err, ms=top["device_ms"], plain_ms=top["plain_ms"],
            bound_ms=top["bound_ms"], bound_by=top["bound_by"],
            library_ms=top["library_ms"], shape=top["shape"],
            device_ms=top["device_ms"], call_ms=top["call_ms"],
            bound_basis=top["bound_basis"],
            library_none_reason=top["library_none_reason"],
            cases=CASES[key]))
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
