"""Thin wrappers, from the benchmark's side, around the program's calls.

- The front end's scan-to-map solve (`ops/scan_match.scan_to_map`, as
  `pipeline/odometry._odom_step_impl` calls it): for the sampled scans of
  a session, a copy of what it was handed (the guess, the matched clouds,
  the map) and what it returned, for the reference to solve again.
- The batched replay's scheduled solve (`scan_to_map_scheduled`, as
  `pipeline/odometry._odom_step_lanes` calls it, every lane at once): the
  same, for the sampled steps of a replay.
- The final pose-graph solve of `SemanticSlam.finish` (its
  `GraphBuilder.optimize`): the graph it was handed and the nodes it
  returned.
- Kernels K1 (`ops/knn_cuda.knn`, `knn_lanes`), K2
  (`ops/gn_cuda.gn_iteration_vec`, `gn_iteration_lanes`) and K3
  (`ops/gn_solve.solve`, `scalar_rows`): in a traced
  session, each launch's inputs, for the bounds of the rooflines, which
  are worked out after the profiled span.
- The LIO chain's step before the scan-to-map solve
  (`pipeline/lio._lio_prestep`): for every scan of a session, the initial
  guess and the body velocity it formed from the IMU rows.
- The front end's deskew (`ops/deskew.deskew_points`, as
  `pipeline/odometry.preprocess` calls it): for the sampled scans, the
  pretreated points and their times it was handed, and the points it
  returned.
- `StageTimer.stage` of a session's timer: in a traced session, each
  stage also opens a profiler span of its name, so that an idle gap of
  the device can be labelled by what the host was doing.
- The functions a cell's checks name (perfbench/checks/): each call's
  arguments and result handed to the check's `keep`, which chooses what
  to keep. Installed only in a cell whose limits name the check.

The answers and problems are kept only in a session started with
`capture` (harness/window.py: the sessions that may be the window's
last). Where a wrapped function is renamed or removed, `install` leaves
it unwrapped and what it fed reads null.
"""

from __future__ import annotations

import contextlib
import functools
import importlib

import torch

_FRONTEND_ARGS = ("pose0", "corner_pts", "corner_mask", "surf_pts",
                  "surf_mask", "corner_map", "corner_map_mask", "surf_map",
                  "surf_map_mask", "cfg", "max_iterations")


class Probes:
    def __init__(self):
        self.sample: set[int] = set()
        self.scan_index = -1
        self.captures: dict[int, dict] = {}
        self.kernel_log: list | None = None
        self.graph_calls: list = []
        self.imu_steps: dict[int, dict] = {}
        self.deskews: dict[int, dict] = {}
        self.checks: dict[str, list] = {}  # check -> what its keep kept
        self.traced = False
        self.capture = True
        self._in_frontend = False
        self._first = False
        self._lane_step = 0
        self._undo: list = []

    # -- installation --
    def _patch(self, module, name: str, make):
        orig = getattr(module, name, None)
        if orig is None:
            return
        setattr(module, name, make(orig))
        self._undo.append((module, name, orig))

    def install(self, checks=None):
        """Wrap the program's functions; `checks` ({name: module}, the
        cell's checks) adds the functions each of them captures."""
        from lis_slam_torch.ops import deskew, gn_cuda, gn_solve, knn_cuda
        from lis_slam_torch.ops import scan_match
        from lis_slam_torch.pipeline import lio, odometry

        self._patch(odometry, "_odom_step_impl", self._wrap_step)
        self._patch(scan_match, "scan_to_map", self._wrap_scan_to_map)
        self._patch(odometry, "_odom_step_lanes", self._wrap_lanes)
        self._patch(scan_match, "scan_to_map_scheduled",
                    self._wrap_scheduled)
        self._patch(gn_solve, "solve", self._wrap_k3(solves=True))
        self._patch(gn_solve, "scalar_rows", self._wrap_k3(solves=False))
        self._patch(knn_cuda, "knn", self._wrap_knn(lanes=False))
        self._patch(knn_cuda, "knn_lanes", self._wrap_knn(lanes=True))
        self._patch(gn_cuda, "gn_iteration_vec", self._wrap_gn(lanes=False))
        self._patch(gn_cuda, "gn_iteration_lanes", self._wrap_gn(lanes=True))
        self._patch(lio, "_lio_prestep", self._wrap_prestep)
        self._patch(deskew, "deskew_points", self._wrap_deskew)
        for name, check in (checks or {}).items():
            for module, attr in check.CAPTURES:
                self._patch(importlib.import_module(module), attr,
                            self._wrap_keep(name, check.keep))
        return self

    def uninstall(self):
        for module, name, orig in reversed(self._undo):
            setattr(module, name, orig)
        self._undo.clear()

    # -- the front end --
    def _wrap_step(self, orig):
        @functools.wraps(orig)
        def step(state, scan, cfg):
            self._in_frontend = True
            if self._want():
                # the program reads this count itself in the same step
                self._first = int(state.kf_count) == 0
            try:
                return orig(state, scan, cfg)
            finally:
                self._in_frontend = False
        return step

    def _wrap_scan_to_map(self, orig):
        @functools.wraps(orig)
        def scan_to_map(*args, **kw):
            want = self._in_frontend and self._want()
            self._in_frontend = False  # later solves of the scan are not
            if not want:
                return orig(*args, **kw)
            named = dict(zip(_FRONTEND_ARGS, args), **kw)
            rec = {k: (v.detach().clone() if isinstance(v, torch.Tensor)
                       else v) for k, v in named.items()}
            st = orig(*args, **kw)
            rec["out_pose"] = st.pose.detach().clone()
            rec["out_it"] = st.it
            rec["first"] = self._first
            self.captures[self.scan_index] = rec
            return st
        return scan_to_map

    def _wrap_lanes(self, orig):
        @functools.wraps(orig)
        def step(state, scan, cfg, allow_kf=True):
            self.scan_index = self._lane_step
            self._lane_step += 1
            self._in_frontend = True
            if self._want():
                # per lane, on the device: no wait on it
                self._first = (state.kf_count == 0).clone()
            try:
                return orig(state, scan, cfg, allow_kf)
            finally:
                self._in_frontend = False
        return step

    def _wrap_scheduled(self, orig):
        names = _FRONTEND_ARGS[:10] + ("n_iters", "refresh_iters")

        @functools.wraps(orig)
        def scheduled(*args, **kw):
            want = self._in_frontend and self._want()
            self._in_frontend = False
            if not want:
                return orig(*args, **kw)
            named = dict(zip(names, args), **kw)
            rec = {k: (v.detach().clone() if isinstance(v, torch.Tensor)
                       else v) for k, v in named.items()}
            st = orig(*args, **kw)
            rec["out_pose"] = st.pose.detach().clone()
            rec["first"] = self._first
            self.captures[self.scan_index] = rec
            return st
        return scheduled

    def _wrap_k3(self, solves: bool):
        def make(orig):
            @functools.wraps(orig)
            def k3(*args):
                st = args[1] if solves else args[0]
                if self.kernel_log is not None and st.pose.is_cuda:
                    self.kernel_log.append(("K3", True, st, solves))
                return orig(*args)
            return k3
        return make

    # -- the LIO chain and the deskew --
    def _wrap_prestep(self, orig):
        @functools.wraps(orig)
        def prestep(*args, **kw):
            out = orig(*args, **kw)
            if self.capture and self.scan_index >= 0:
                _pre, guess, _g, _a, vel_body, ok = out
                self.imu_steps[self.scan_index] = {
                    "guess": guess.detach().clone(),
                    "vel_body": vel_body.detach().clone(), "ok": bool(ok)}
            return out
        return prestep

    def _wrap_deskew(self, orig):
        @functools.wraps(orig)
        def deskew_points(points, t, info, valid, vel_body=None):
            out = orig(points, t, info, valid, vel_body=vel_body)
            if (self._in_frontend and points.dim() == 2 and self._want()
                    and self.scan_index not in self.deskews):
                self.deskews[self.scan_index] = {
                    "points": points.detach().clone(),
                    "t": t.detach().clone(), "valid": valid.detach().clone(),
                    "vel": vel_body is not None,
                    "out": out.detach().clone()}
            return out
        return deskew_points

    # -- the cell's checks --
    def _wrap_keep(self, name: str, keep):
        def make(orig):
            @functools.wraps(orig)
            def kept(*args, **kw):
                out = orig(*args, **kw)
                if self.capture:
                    item = keep(self.scan_index, self.sample, args, kw, out)
                    if item is not None:
                        self.checks.setdefault(name, []).append(item)
                return out
            return kept
        return make

    # -- kernels, traced sessions only --
    def _wrap_knn(self, lanes: bool):
        def make(orig):
            @functools.wraps(orig)
            def knn(query, ref, ref_mask, k=5, max_sq_dist=None):
                if self.kernel_log is not None and query.is_cuda:
                    self.kernel_log.append(("K1", lanes, query, ref, ref_mask,
                                            k, max_sq_dist))
                return orig(query, ref, ref_mask, k, max_sq_dist)
            return knn
        return make

    def _wrap_gn(self, lanes: bool):
        # (pose or rows, corner pts, mask, cand, ok, surf pts, mask, cand,
        # ok, corner weight, surf weight, [cfg,] k)
        def make(orig):
            @functools.wraps(orig)
            def gn(*args):
                if self.kernel_log is not None and args[1].is_cuda:
                    self.kernel_log.append(
                        ("K2", lanes, (args[1], args[2], args[9]),
                         (args[5], args[6], args[10]), args[-1]))
                return orig(*args)
            return gn
        return make

    # -- per session --
    def _want(self) -> bool:
        """Whether this scan's front-end problem is kept."""
        return (self.capture and self.scan_index in self.sample
                and self.scan_index not in self.captures)

    def start_session(self, system=None, traced: bool = False,
                      capture: bool = True):
        self.captures = {}
        self.deskews = {}
        self.imu_steps = {}
        self.checks = {}
        self._lane_step = 0
        self.graph_calls = []
        self.traced = traced
        self.capture = capture
        if system is None:
            return
        graph = getattr(system, "graph", None)
        if capture and graph is not None and hasattr(graph, "optimize"):
            orig = graph.optimize

            @functools.wraps(orig)
            def optimize(*a, **kw):
                before = dict(nodes=[n.copy() for n in graph.nodes],
                              edges=[(i, j, z.copy(), w.copy(), r)
                                     for i, j, z, w, r in graph.edges],
                              priors=[(i, z.copy(), w.copy())
                                      for i, z, w in graph.priors])
                out = orig(*a, **kw)
                before["out"] = out.copy()
                self.graph_calls[:] = [before]  # the last solve is judged
                return out
            graph.optimize = optimize
        timer = getattr(system, "timer", None)
        if traced and timer is not None:
            orig_stage = timer.stage

            @contextlib.contextmanager
            def stage(name):
                with torch.profiler.record_function(f"stage:{name}"):
                    with orig_stage(name):
                        yield
            timer.stage = stage
