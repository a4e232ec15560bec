"""Replay a KITTI odometry sequence through the full SLAM pipeline of the
port (the counterpart of examples/run_kitti.py; the reference's
`roslaunch lis_slam run.launch` + `rosbag play`, README.md section 5).

The native loader (runtime/native.py) prefetches and range-gates the .bin
scans on host threads; each scan is padded to the sensor buffer
(driver.pad_scan) and goes to the device in one pinned host-to-device
copy; SemanticSlam runs on the card, or on the host with --cpu. The
trajectory is written in KITTI format and, where poses/<seq>.txt exists,
evaluated against it (ATE aligned, RPE per frame).

    python -m lis_slam_torch.run_kitti --root /data/kitti --sequence 05 \\
        --out 05_pred.txt [--preset kitti] [--max-scans N] [--save-map m.pcd]
        [--match-source hybrid] [--gn-backend pallas] [--debug-dir d] [--cpu]

`write_sequence` writes clouds and poses in that layout (a synthetic
sequence for a run without KITTI data).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np
import torch

from .config import PRESETS, SlamConfig
from .io import kitti
from .pipeline import driver, odometry, slam, trajectory
from .runtime import native
from .utils import device as devices, se3_np
from .utils.profiling import StageTimer


def write_sequence(root: str, sequence: str, clouds,
                   poses6: np.ndarray) -> None:
    """KITTI layout under `root`: sequences/<seq>/velodyne/%06d.bin (float32
    xyzi), calib.txt with an identity Tr (the velodyne frame is the camera
    frame), times.txt (10 Hz), and poses/<seq>.txt (3 x 4 rows of each
    pose6)."""
    velo = os.path.join(root, "sequences", sequence, "velodyne")
    os.makedirs(velo, exist_ok=True)
    os.makedirs(os.path.join(root, "poses"), exist_ok=True)
    for i, pts in enumerate(clouds):
        np.ascontiguousarray(pts, np.float32).tofile(
            os.path.join(velo, f"{i:06d}.bin"))
    seq_dir = os.path.dirname(velo)
    with open(os.path.join(seq_dir, "calib.txt"), "w") as f:
        f.write("Tr: " + " ".join(str(v) for v in np.eye(4)[:3].ravel())
                + "\n")
    np.savetxt(os.path.join(seq_dir, "times.txt"),
               np.arange(len(poses6)) * 0.1)
    np.savetxt(os.path.join(root, "poses", f"{sequence}.txt"), np.stack(
        [se3_np.pose_to_matrix(p)[:3].ravel() for p in poses6]))


def upload_scan(sin: odometry.ScanInput, count: int,
                device: torch.device) -> odometry.ScanInput:
    """A host ScanInput (pad_scan's, without an IMU window) on `device`:
    points, scan start, velocity and angular rate in one host-to-device
    copy from pinned memory; the valid mask is built on the device."""
    if device.type != "cuda":
        return sin
    p = sin.points.shape[0]
    host = torch.cat([sin.points.reshape(-1), sin.scan_start.reshape(1),
                      sin.vel, sin.ang_rate]).pin_memory()
    buf = host.to(device, non_blocking=True)
    return sin._replace(
        points=buf[:4 * p].view(p, 4),
        valid=torch.arange(p, device=device) < min(count, p),
        scan_start=buf[4 * p], vel=buf[4 * p + 1:4 * p + 4],
        ang_rate=buf[4 * p + 4:4 * p + 7])


def replay_kitti(cfg: SlamConfig, root: str, sequence: str,
                 max_scans: int = 0, device: torch.device | str = "cuda",
                 debug_dir: str | None = None, build_map: bool = False,
                 timer: StageTimer | None = None):
    """SemanticSlam over the sequence's first `max_scans` scans (all with
    0), fed by the native loader; the scan loop is timed under stage
    "scan" of `timer`. Returns (system, SlamResult)."""
    device = devices.resolve(device)
    seq = kitti.KittiSequence(root, sequence)
    n = len(seq) if not max_scans else min(max_scans, len(seq))
    print(f"sequence {sequence}: {n} scans, native loader: "
          f"{native.available()}")
    files = [os.path.join(seq.velo_dir, seq.files[i]) for i in range(n)]
    loader = native.AsyncScanLoader(
        files, max_points=cfg.sensor.max_raw_points,
        capacity=cfg.runtime.queue_capacity,
        n_threads=cfg.runtime.num_host_threads,
        min_range=cfg.sensor.lidar_min_range,
        max_range=cfg.sensor.lidar_max_range)
    system = slam.SemanticSlam(cfg, debug_dir=debug_dir, device=device)
    timer = timer if timer is not None else StageTimer()
    try:
        for i, (buf, count) in enumerate(loader):
            with timer.stage("scan"):
                sin = upload_scan(driver.pad_scan(buf[:count], cfg), count,
                                  device)
                system.process_scan(sin)
            if i + 1 == n:
                break
    finally:
        loader.close()
    return system, system.finish(build_map=build_map)


def ground_truth6(root: str, sequence: str, n: int) -> np.ndarray | None:
    """The first n ground-truth poses (velodyne frame) as pose6, relative
    to the first; None without poses/<seq>.txt."""
    gt = kitti.KittiSequence(root, sequence).ground_truth()
    if gt is None:
        return None
    gt6 = np.stack([se3_np.matrix_to_pose(T) for T in gt[:n]])
    return trajectory.relative_to_first(gt6)


def main(argv=None):
    """The command line; returns (system, SlamResult, the StageTimer whose
    stage "scan" timed the scan loop)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", required=True)
    ap.add_argument("--sequence", default="05")
    ap.add_argument("--out", default="pred.txt")
    ap.add_argument("--preset", default="kitti", choices=sorted(PRESETS))
    ap.add_argument("--max-scans", type=int, default=0)
    ap.add_argument("--save-map", default="")
    ap.add_argument("--match-source", default="",
                    choices=("", "sharp", "full_ds", "hybrid"),
                    help="matched clouds: hybrid (sharp corners + "
                         "voxel-uniform full surf), sharp (feature subsets "
                         "only) or full_ds (voxel-downsampled full clouds, "
                         "the reference's currentCloudInit); empty keeps "
                         "the preset's")
    ap.add_argument("--gn-backend", default="", choices=("", "xla", "pallas"),
                    help="GN iteration: pallas (the fused kernel K2) or xla "
                         "(plain PyTorch); empty keeps the preset's")
    ap.add_argument("--debug-dir", default="",
                    help="dump descriptor images, loop markers and the "
                         "global map there")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the host (the kernels' plain versions)")
    args = ap.parse_args(argv)

    cfg = PRESETS[args.preset]()
    m = cfg.matching
    if args.match_source:
        m = dataclasses.replace(m, match_source=args.match_source)
    if args.gn_backend:
        m = dataclasses.replace(m, gn_backend=args.gn_backend)
    cfg = cfg.replace(matching=m)

    timer = StageTimer(log_every=100)
    t0 = time.perf_counter()
    system, res = replay_kitti(
        cfg, args.root, args.sequence, max_scans=args.max_scans,
        device="cpu" if args.cpu else "cuda",
        debug_dir=args.debug_dir or None, build_map=bool(args.save_map),
        timer=timer)
    wall = time.perf_counter() - t0
    trajectory.write_kitti(args.out, res.poses)
    print(f"wrote {args.out}: {len(res.poses)} poses, {res.n_submaps} "
          f"submaps, {res.n_loops} loop factors ({len(res.poses) / wall:.2f} "
          "scans/s with set-up and finish)")
    print(timer.summary())
    if args.save_map and res.global_map is not None:
        kitti.write_pcd(args.save_map, res.global_map[:, :3],
                        res.global_map[:, 3])
        print(f"wrote {args.save_map}: {len(res.global_map)} points")
    gt_rel = ground_truth6(args.root, args.sequence, len(res.poses))
    if gt_rel is not None:
        ate = trajectory.ate_rmse(res.poses, gt_rel, align=True)
        rpe_t, rpe_r = trajectory.rpe(res.poses, gt_rel)
        print(f"ATE {ate:.3f} m | RPE {rpe_t:.3f} m / {rpe_r:.3f} deg per "
              "frame")
    return system, res, timer


if __name__ == "__main__":
    main()
