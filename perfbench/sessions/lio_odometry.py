"""LioOdometry sessions: a fresh `LioOdometry` a session; each scan's
host cloud and IMU window go to `process_scan`, and its pose is read
back."""

from __future__ import annotations

import time

import numpy as np

from perfbench.harness import program


class Sessions:
    def __init__(self, cfg, config: dict, traffic, device, probes):
        self.cfg, self.traffic, self.device = cfg, traffic, device
        self.probes = probes

    def run(self, traced: bool = False,
            capture: bool = True) -> program.Session:
        import torch
        from lis_slam_torch.pipeline import lio

        dev, probes = self.device, self.probes
        s = program.Session(captured=capture)
        t0 = time.perf_counter()
        system = lio.LioOdometry(self.cfg, dev)
        probes.start_session(None, traced, capture)
        for i, scan in enumerate(self.traffic.scans):
            probes.scan_index = i
            imu_t, gyro, accel = scan.imu
            t = time.perf_counter()
            with program.span(traced, "scan"):
                pose = system.process_scan(scan.points, imu_t, gyro, accel,
                                           scan.start).cpu()
            s.latencies_s.append(time.perf_counter() - t)
            s.poses.append(pose.numpy().astype(np.float64))
        probes.scan_index = -1
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        s.wall_s = time.perf_counter() - t0
        s.scans = len(s.latencies_s)
        s.imu_s = system.diag.imu_s
        if capture:
            s.captures, s.imu_steps = probes.captures, probes.imu_steps
            s.deskews = probes.deskews
        return s
