"""The system under test: lis_slam_torch, built from a configuration file
and driven one session at a time, closed loop.

A configuration file (perfbench/configs/<name>.json) names the port's
preset (`preset`), the keys it changes (`overrides`, dotted), and repeats
the sizes it runs at (`sizes`, dotted), which `build_config` checks
against the built configuration so that the file stays the configuration
as run.

A traffic's `session` names its driver, perfbench/sessions/<name>.py,
whose `Sessions(cfg, config, traffic, device, probes)` runs one session
of the traffic a call: `run(traced=False, capture=True) -> Session`.
With `capture` the probes keep what the check reads (harness/probes.py).
A scan's latency runs from the moment its host arrays are handed over to
the moment its pose is on the host.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
from dataclasses import dataclass, field

import numpy as np


def _set(obj, dotted: str, value):
    head, _, rest = dotted.partition(".")
    if not rest:
        return dataclasses.replace(obj, **{head: value})
    return dataclasses.replace(obj, **{head: _set(getattr(obj, head), rest,
                                                  value)})


def _get(obj, dotted: str):
    for part in dotted.split("."):
        obj = getattr(obj, part)
    return obj


def build_config(config: dict):
    """The port's SlamConfig for a configuration file."""
    from lis_slam_torch import config as C

    cfg = getattr(C, config["preset"])()
    for key, value in config.get("overrides", {}).items():
        cfg = _set(cfg, key, tuple(value) if isinstance(value, list)
                   else value)
    for key, value in config.get("sizes", {}).items():
        got = _get(cfg, key)
        if (list(got) if isinstance(got, tuple) else got) != value:
            raise ValueError(f"{config['name']}: {key} is {got!r} in the "
                             f"built configuration, the file says {value!r}")
    return cfg


@dataclass
class Session:
    latencies_s: list = field(default_factory=list)
    poses: list = field(default_factory=list)  # host pose6 per scan
    wall_s: float = 0.0
    cpu_s: tuple = (0.0, 0.0)  # the process's user and system CPU s
    captured: bool = False  # the probes kept what the check reads
    captures: dict = field(default_factory=dict)
    graph_calls: list = field(default_factory=list)
    imu_steps: dict = field(default_factory=dict)  # scan -> LIO prestep
    deskews: dict = field(default_factory=dict)  # scan -> the deskew's I/O
    checks: dict = field(default_factory=dict)  # check -> what it kept
    stage_s: dict = field(default_factory=dict)  # stage -> (count, total s)
    imu_s: float = 0.0
    lane_poses: np.ndarray | None = None  # (B, N, 6), a batched replay
    scans: int = 0  # answers of the session (scans of all lanes)
    back_end: dict | None = None  # what the graph check reads, host copies


def span(traced: bool, name: str):
    """A profiler span of the benchmark's own, in a traced session."""
    if not traced:
        return contextlib.nullcontext()
    import torch

    return torch.profiler.record_function(f"bench:{name}")


def stage_totals(timer) -> dict:
    return {k: (v.count, v.total_s) for k, v in timer.stats.items()}


def back_end(system, result) -> dict:
    """Host copies of what the loop-closed poses were built from."""
    kfs = system.keyframes
    subs = system.collector.submaps
    return dict(
        kf_pose_init=np.stack([k.pose_init for k in kfs]) if kfs else None,
        kf_submap=np.asarray([k.submap_id for k in kfs]),
        kf_scan_ids=np.asarray(system.kf_scan_ids),
        submap_pose_init=np.stack([s.pose_init for s in subs])
        if subs else None,
        raw_poses=np.asarray(result.raw_poses),
        poses=np.asarray(result.poses), n_submaps=result.n_submaps,
        n_loops=result.n_loops)


def sessions_for(name: str):
    """The session driver of a traffic's `session`:
    perfbench/sessions/<name>.py's `Sessions`."""
    return importlib.import_module(f"perfbench.sessions.{name}").Sessions
