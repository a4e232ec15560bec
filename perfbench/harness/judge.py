"""How `correct` is decided: the program's answers in the last captured
session of the window against the plain references of perfbench/reference/
and against the true poses of the traffic.

Numbers (each cell compares those in perfbench/limits/<cell>.json; the
rest are printed as readings; harness/spec.py `JUDGE_NUMBERS` lists them,
and a limits key outside them names the number of a check module,
perfbench/checks/). A gap between two poses is the largest displacement
of a point 20 m from the sensor: |dt| + 20 m x angle(dR).

- `odom_gap_rms_m`, `odom_gap_max_m`: over the sampled answers of the
  session (the first scan, the last and some drawn from the seed; in a
  batched replay every lane of the sampled steps), the root mean square
  and the widest of the gaps between the pose the program returned and the
  reference's float64 solve of the same scan-to-map problem (the guess,
  matched clouds and map the front end was handed), after the same angle
  clamps. For the first scan of a session the answer is the guess itself.
- `rpe_max_m`: over the sampled answers after the first, the widest gap
  between the motion from the previous answer to this one and the true
  motion between the two scans: the whole front end (pretreatment,
  deskew, features, the map it keeps) against the traffic's truth.
- `graph_gap_m` (sessions that return loop-closed poses): the widest gap,
  over every scan of the session, between the poses `finish()` returned
  and the reference's: the front-end poses the program returned under the
  configured drift, corrected by the reference's solve of the final pose
  graph the program built.
- `imu_guess_gap_m` (LioOdometry sessions): the widest gap, over every
  scan after the first, between the initial guess the program's IMU chain
  formed and the reference chain's (reference/imu_chain.py), which starts
  from the raw IMU rows and is anchored, as the program's, on the poses
  the front end returned.
- `deskew_gap_m` (LioOdometry sessions): over the sampled scans, the
  widest distance between a point as the program deskewed it and as the
  reference deskews the same pretreated point with its own chain's gyro
  window and body velocity.
- `front_ate_m`, `loop_ate_m`: the translation RMS of the front-end and
  the loop-closed poses against the true ones, both taken relative to the
  first pose.

The references read the program's state where they can only follow it
step by step (the map and matched clouds of a scan, the pretreated cloud,
the factors of the graph, the returned poses the IMU chain is anchored
on), and read the program's answers otherwise only to judge them.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from perfbench.reference import imu_chain, pose_graph, scan_to_map
from perfbench.reference.numerics import Numerics

from .drift import drift_hook, matrix_to_pose_np
from .render import pose_to_matrix_np

LEVER_M = 20.0


def pose_gap(a, b) -> float:
    """Largest displacement of a point LEVER_M from the sensor between
    two pose6 [roll, pitch, yaw, x, y, z]."""
    Ta, Tb = pose_to_matrix_np(np.asarray(a, np.float64)), \
        pose_to_matrix_np(np.asarray(b, np.float64))
    dR = Ta[:3, :3].T @ Tb[:3, :3]
    # the angle from its sine and cosine: acos of the cosine alone reads
    # ~1.5e-8 rad for equal rotations
    sin = 0.5 * math.hypot(dR[2, 1] - dR[1, 2], dR[0, 2] - dR[2, 0],
                           dR[1, 0] - dR[0, 1])
    ang = math.atan2(sin, (np.trace(dR) - 1.0) / 2.0)
    return float(np.linalg.norm(Ta[:3, 3] - Tb[:3, 3]) + LEVER_M * ang)


def rms(values) -> float:
    return math.sqrt(sum(v * v for v in values) / len(values))


def _host(rec: dict) -> dict:
    out = {}
    for k, v in rec.items():
        out[k] = v.cpu().numpy() if hasattr(v, "cpu") else v
    return out


def _clamp(pose, runtime: dict):
    p = np.array(pose, np.float64)
    rt, zt = runtime["rotation_tolerance"], runtime["z_tolerance"]
    p[:2] = np.clip(p[:2], -rt, rt)
    p[5] = np.clip(p[5], -zt, zt)
    return p


@dataclasses.dataclass
class Problem:
    """What the references read, copied to the host, the program freed."""

    captures: dict  # answer key -> host record of its scan-to-map problem
    got: dict  # answer key -> the pose6 the program returned
    answers: list  # pose6 per scan that process_scan returned
    back_end: dict | None
    graph: dict | None  # the final solve's input and output
    matching: dict
    runtime: dict
    graph_cfg: dict
    drift_per_scan: float
    gt: np.ndarray | None = None  # (n, 6) the true poses of the scans
    previous: dict = dataclasses.field(default_factory=dict)  # key -> the
    # pose the program returned for the scan before it (same lane)
    chain: dict | None = None  # the IMU configuration, LioOdometry sessions
    windows: list = dataclasses.field(default_factory=list)  # IMU rows
    starts: list = dataclasses.field(default_factory=list)  # scan stamps
    imu_steps: dict = dataclasses.field(default_factory=dict)
    deskews: dict = dataclasses.field(default_factory=dict)


def _lanes(rec: dict) -> list[dict]:
    """A scheduled solve's record split into one record a lane."""
    n = rec["pose0"].shape[0]
    sched = (rec["n_iters"], tuple(rec["refresh_iters"]))
    return [{**{k: (v[b] if isinstance(v, np.ndarray) and v.ndim and
                    v.shape[0] == n else v) for k, v in rec.items()},
             "schedule": sched} for b in range(n)]


def problem_of(session, cfg, traffic, lio: bool = False) -> Problem:
    """The answers of a session and what the references need, on the
    host. A session's answers are keyed by scan index, or by (step, lane)
    in a batched replay. `lio`: the session ran the LioOdometry chain."""
    graph = session.graph_calls[-1] if session.graph_calls else None
    captures = {i: _host(r) for i, r in session.captures.items()}
    answers = [np.asarray(p, np.float64) for p in session.poses]
    if session.lane_poses is not None:
        captures = {(i, b): r for i, rec in captures.items()
                    for b, r in enumerate(_lanes(rec))}
        got = {k: session.lane_poses[k[1], k[0]] for k in captures}
        previous = {k: session.lane_poses[k[1], k[0] - 1] for k in captures
                    if k[0] > 0}
    else:
        got = {i: answers[i] for i in captures}
        previous = {i: answers[i - 1] for i in captures if i > 0}
    prob = Problem(
        captures=captures, got=got, answers=answers, previous=previous,
        back_end=session.back_end, graph=graph,
        matching=dataclasses.asdict(cfg.matching),
        runtime=dataclasses.asdict(cfg.runtime),
        graph_cfg=dataclasses.asdict(cfg.graph),
        drift_per_scan=float(traffic.params.get("drift_per_scan", 0.0)),
        gt=np.asarray(traffic.gt, np.float64))
    if lio:
        prob.chain = dataclasses.asdict(cfg.imu)
        prob.windows = [s.imu for s in traffic.scans]
        prob.starts = [s.start for s in traffic.scans]
        prob.imu_steps = {i: {k: (v.cpu().numpy() if hasattr(v, "cpu")
                                  else v) for k, v in r.items()}
                          for i, r in session.imu_steps.items()}
        prob.deskews = {i: _host(r) for i, r in session.deskews.items()}
    return prob


def odom_answers(prob: Problem, num: Numerics) -> dict:
    """answer key -> the reference's answer in precision `num`."""
    out = {}
    for i, rec in sorted(prob.captures.items()):
        if bool(rec["first"]):
            pose = np.asarray(rec["pose0"], np.float64)
        else:
            pose, _it = scan_to_map.scan_to_map(rec, prob.matching, num)
        out[i] = _clamp(pose, prob.runtime)
    return out


def graph_answers(prob: Problem, num: Numerics):
    """The loop-closed poses of every scan, the final graph solved by the
    reference in precision `num`."""
    be, g = prob.back_end, prob.graph
    gc = prob.graph_cfg
    nodes = pose_graph.optimize(
        g["nodes"], g["edges"], g["priors"], damping=gc["damping"],
        iterations=gc["max_iterations"], robust_c=gc["robust_c"],
        gnc_start_c=gc["gnc_start_c"], num=num)
    hook = drift_hook(prob.drift_per_scan)
    raw = np.stack([hook(p, i) for i, p in enumerate(prob.answers)])
    return pose_graph.correct_trajectory(
        raw, be["kf_scan_ids"], be["kf_pose_init"], be["kf_submap"],
        be["submap_pose_init"], nodes, pose_to_matrix_np, matrix_to_pose_np)


def ate_m(poses, gt) -> float:
    """Translation RMS of poses against the true ones, both taken
    relative to their first pose (no alignment)."""
    def rel(ps):
        T0 = np.linalg.inv(pose_to_matrix_np(np.asarray(ps[0])))
        return np.stack([(T0 @ pose_to_matrix_np(np.asarray(p)))[:3, 3]
                         for p in ps])
    d = rel(poses) - rel(gt[:len(poses)])
    return float(np.sqrt(np.mean(np.sum(d * d, axis=1))))


def _motion(a, b) -> np.ndarray:
    """pose6 of the motion from pose a to pose b."""
    return matrix_to_pose_np(np.linalg.inv(pose_to_matrix_np(a))
                             @ pose_to_matrix_np(b))


def rpe_max(prob: Problem, odom: dict) -> float:
    """The widest gap between an answer's motion from the scan before it
    and the true motion, over the sampled answers after the first."""
    gaps = []
    for k, prev in prob.previous.items():
        i = k[0] if isinstance(k, tuple) else k
        gaps.append(pose_gap(_motion(prev, odom[k]),
                             _motion(prob.gt[i - 1], prob.gt[i])))
    return max(gaps) if gaps else math.inf


def chain_steps(prob: Problem, dtype=np.float64) -> list:
    """The reference chain's `before` of every scan, anchored on the
    program's returned poses."""
    return imu_chain.run_chain(prob.chain, prob.windows, prob.starts,
                               prob.answers, dtype)


def deskewed(prob: Problem, steps: list, num: Numerics) -> dict:
    """scan -> the reference's deskew of the sampled scans' pretreated
    points."""
    return {i: imu_chain.deskew(r["points"], r["t"], r["valid"], steps[i],
                                num) for i, r in prob.deskews.items()}


def readings(prob: Problem, answers=None) -> dict:
    """The numbers: the program's answers (or `answers`, another side put
    in the program's place: {"odom": {key: pose6}, "graph": (n, 6),
    "guess": {scan: pose6}, "deskew": {scan: (P, 3)}}) against the
    references in float64 and against the true poses."""
    ref = Numerics("float64")
    out = {}
    odom_ref = odom_answers(prob, ref)
    got = prob.got if answers is None else answers["odom"]
    if not odom_ref or set(got) != set(odom_ref):
        out["odom_gap_rms_m"] = out["odom_gap_max_m"] = math.inf
        out["rpe_max_m"] = math.inf
    else:
        gaps = [pose_gap(got[i], odom_ref[i]) for i in odom_ref]
        out["odom_gap_rms_m"], out["odom_gap_max_m"] = rms(gaps), max(gaps)
        out["rpe_max_m"] = rpe_max(prob, got)
    if answers is None and prob.answers:
        out["front_ate_m"] = ate_m(prob.answers, prob.gt)
    if prob.back_end is not None:
        if prob.graph is None:
            out["graph_gap_m"] = out["loop_ate_m"] = math.inf
        else:
            graph_ref = graph_answers(prob, ref)
            poses = (prob.back_end["poses"] if answers is None
                     else answers["graph"])
            out["graph_gap_m"] = (math.inf if len(poses) != len(graph_ref)
                                  else max(pose_gap(a, b) for a, b in
                                           zip(poses, graph_ref)))
            out["loop_ate_m"] = ate_m(poses, prob.gt)
    if prob.chain is not None:
        steps = chain_steps(prob)
        guess = ({i: r["guess"] for i, r in prob.imu_steps.items()}
                 if answers is None else answers["guess"])
        ref_guess = {i: st["guess"] for i, st in enumerate(steps)
                     if st["guess"] is not None}
        out["imu_guess_gap_m"] = (
            max(pose_gap(guess[i], ref_guess[i]) for i in ref_guess)
            if ref_guess and set(guess) >= set(ref_guess) else math.inf)
        pts = ({i: r["out"] for i, r in prob.deskews.items()}
               if answers is None else answers["deskew"])
        ref_pts = deskewed(prob, steps, ref)
        out["deskew_gap_m"] = (
            max(float(np.max(np.linalg.norm(
                (np.asarray(pts[i], np.float64) - ref_pts[i])
                [prob.deskews[i]["valid"]], axis=1), initial=0.0))
                for i in ref_pts)
            if ref_pts and set(pts) == set(ref_pts) else math.inf)
    return {k: (v if math.isfinite(v) else math.inf) for k, v in out.items()}


def control_answers(prob: Problem) -> dict:
    """The references one precision below the stated one, put in the
    program's place: the geometry (stated float32) with bfloat16 storage,
    the IMU chain (stated float64) in float32."""
    low = Numerics("bfloat16")
    ans = {"odom": odom_answers(prob, low)}
    if prob.back_end is not None and prob.graph is not None:
        ans["graph"] = graph_answers(prob, low)
    if prob.chain is not None:
        steps32 = chain_steps(prob, np.float32)
        ans["guess"] = {i: st["guess"] for i, st in enumerate(steps32)
                        if st["guess"] is not None}
        ans["deskew"] = deskewed(prob, chain_steps(prob), low)
    return ans


def verdict(numbers: dict, limits: dict) -> tuple[bool, list]:
    """(correct, [(name, number, limit)]): correct where every number of
    the cell is finite and within its limit."""
    rows, ok = [], True
    for name, lim in sorted(limits.items()):
        v = numbers.get(name, math.inf)
        rows.append((name, v, lim))
        ok = ok and math.isfinite(v) and v <= lim
    return ok, rows
