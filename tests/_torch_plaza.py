"""Shared inputs of the port's back-end parity tests: the 16-beam
configuration of tests/test_slam_pipeline.py with back-end capacities cut
to a 16 x 900 scan (both packages get the same config), and 16-beam
renders of the bench's plaza lap (bench.py:145-167)."""

import dataclasses

import numpy as np

import lis_slam_tpu.io.synthetic as jsyn
from lis_slam_tpu.config import (KeyframeConfig as JKeyframeConfig,
                                 SensorConfig as JSensorConfig,
                                 SlamConfig as JSlamConfig)
from lis_slam_torch.config import SlamConfig
from lis_slam_torch.io import synthetic_torch


def tiny_cfgs(**matching):
    """(JAX config, port config), equal field by field. A 16 x 900 scan
    has at most 14400 points, so the back end's buffers are cut to that
    scale (the default capacities are sized for HDL-64 and only cost CPU
    time here)."""
    base = JSlamConfig()
    j = base.replace(
        sensor=JSensorConfig(n_scan=16, horizon_scan=900, downsample_rate=1,
                             lidar_min_range=1.0, lidar_max_range=80.0,
                             max_raw_points=16 * 900),
        feature=dataclasses.replace(
            base.feature, max_corner_points=1024, max_surf_points=8192,
            max_sharp_corner_points=512, max_sharp_surf_points=1024),
        matching=dataclasses.replace(base.matching, **{
            **dict(corner_map_capacity=8192, surf_map_capacity=32768,
                   hash_table_slots=1 << 14, degeneracy_eigen_threshold=10.0),
            **matching}),
        submap=dataclasses.replace(
            base.submap, translation_max=8.0, frames_size=12,
            corner_capacity=8192, surf_capacity=16384, max_submaps=64,
            local_surf_capacity=16384, local_corner_capacity=4096,
            matched_surf_capacity=2048, matched_corner_capacity=1024,
            keyframe_class_capacity=2048, class_capacity=8192),
        loop=dataclasses.replace(base.loop, verify_target_capacity=8192),
        keyframe=JKeyframeConfig(min_distance=0.2, min_yaw=0.2))
    return j, SlamConfig(**{f.name: getattr(j, f.name)
                            for f in dataclasses.fields(j)})


def render_plaza(n, seed0=200, horizon=900):
    """16-beam renders (with labels) of the first n scans of the plaza's
    exactly periodic 100-scan lap. Returns (scans, gt poses (101, 6))."""
    world = synthetic_torch.plaza_world()
    gt = jsyn.circular_trajectory(101, radius=10.0,
                                  speed=2.0 * np.pi * 10.0 / (100 * 0.1))
    orig = jsyn.hdl64_elevations
    jsyn.hdl64_elevations = lambda: np.linspace(15.0, -15.0, 16)
    try:
        scans = [jsyn.render_scan(world, gt[i], None, n_scan=16,
                                  horizon=horizon, seed=seed0 + i,
                                  noise=0.01, max_range=90.0)
                 for i in range(n)]
    finally:
        jsyn.hdl64_elevations = orig
    return scans, gt
