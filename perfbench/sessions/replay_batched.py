"""Batched replays (`parallel/batched.replay_batched`) of every lane's
host clouds, one replay a session. Its poses are every lane's, (B, N,
6); a replay has no per-scan latency."""

from __future__ import annotations

import time

import numpy as np

from perfbench.harness import program


class Sessions:
    def __init__(self, cfg, config: dict, traffic, device, probes):
        self.cfg, self.device, self.probes = cfg, device, probes
        self.seqs = [[s.points for s in lane] for lane in traffic.lanes]

    def run(self, traced: bool = False,
            capture: bool = True) -> program.Session:
        import torch
        from lis_slam_torch.parallel import batched

        s = program.Session(captured=capture)
        t0 = time.perf_counter()
        self.probes.start_session(None, traced, capture)
        with program.span(traced, "replay"):
            poses = batched.replay_batched(self.seqs, self.cfg,
                                           device=self.device)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        s.wall_s = time.perf_counter() - t0
        s.lane_poses = np.asarray(poses, np.float64)
        s.scans = int(s.lane_poses.shape[0] * s.lane_poses.shape[1])
        if capture:
            s.captures = self.probes.captures
        return s
