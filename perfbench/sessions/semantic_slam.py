"""SemanticSlam sessions: a fresh `SemanticSlam(pose_hook=drift)` a
session. Each scan is padded (`pipeline/driver.pad_scan`), copied to the
card from pinned memory (`run_kitti.upload_scan`) and fed to
`process_scan` with its labels and, where the traffic has them, its IMU
rows; its pose is read back. `finish()` ends the session. Where the
configuration names RangeNet weights (`"weights": {"rangenet": <name>,
"seed": <n>}`), set-up builds them once (perfbench/weights/<name>.py) and
every session's SemanticSlam labels its keyframes with them."""

from __future__ import annotations

import time

import numpy as np

from perfbench.harness import program, spec
from perfbench.harness.drift import drift_hook


class Sessions:
    def __init__(self, cfg, config: dict, traffic, device, probes):
        self.cfg, self.traffic, self.device = cfg, traffic, device
        self.probes = probes
        self.hook = drift_hook(float(traffic.params.get("drift_per_scan",
                                                        0.0)))
        self.system_kw = {}
        weights = config.get("weights")
        if weights is not None:
            self.system_kw["rangenet_params"] = spec.weights_builder(
                weights["rangenet"])(cfg, int(weights["seed"]), device)

    def run(self, traced: bool = False,
            capture: bool = True) -> program.Session:
        import torch
        from lis_slam_torch import run_kitti
        from lis_slam_torch.pipeline import driver, slam

        cfg, dev, probes = self.cfg, self.device, self.probes
        s = program.Session(captured=capture)
        t0 = time.perf_counter()
        system = slam.SemanticSlam(cfg, pose_hook=self.hook, device=dev,
                                   **self.system_kw)
        probes.start_session(system, traced, capture)
        for i, scan in enumerate(self.traffic.scans):
            probes.scan_index = i
            imu = {}
            if scan.imu is not None:
                imu = dict(zip(("imu_time", "imu_gyro", "imu_accel"),
                               scan.imu))
            t = time.perf_counter()
            with program.span(traced, "scan"):
                sin = driver.pad_scan(scan.points, cfg)
                sin = run_kitti.upload_scan(sin, len(scan.points), dev)
                pose = system.process_scan(sin, gt_labels=scan.labels,
                                           timestamp=scan.start, **imu)
                pose = pose.cpu()
            s.latencies_s.append(time.perf_counter() - t)
            s.poses.append(pose.numpy().astype(np.float64))
        probes.scan_index = -1
        with program.span(traced, "finish"):
            res = system.finish()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        s.wall_s = time.perf_counter() - t0
        s.scans = len(s.latencies_s)
        s.stage_s = program.stage_totals(system.timer)
        if capture:
            s.captures, s.graph_calls = probes.captures, probes.graph_calls
            s.imu_steps, s.deskews = probes.imu_steps, probes.deskews
            s.back_end = program.back_end(system, res)
        return s
