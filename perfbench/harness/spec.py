"""Everything a run needs, found by name from BENCHMARK.json.

- the cell: an entry of `workloads`;
- its configuration: the `file` of the entry of `configs` it names;
- its traffic: `perfbench/traffic/<traffic>.json`, parameters that the
  one generator (harness/traffic.py) reads;
- its limits: `perfbench/limits/<workload>.json`, each number that
  decides `correct` with its limit;
- its checks: for each key of its limits that the judge does not form
  (`JUDGE_NUMBERS`), the `perfbench/checks/<check>.py` whose `NUMBERS`
  name it; a key that no check forms stops the run in set-up;
- its weights: a configuration that names `"weights": {"rangenet":
  <name>, "seed": <n>}` gets them from `perfbench/weights/<name>.py`;
- its metrics: the `end_to_end` entries (all cells, or those listed under
  an entry's `workloads`) and, in a traced run, the `per_layer` entries
  that list the cell, each read by `perfbench/metrics/<name>.py`.

A later cell, configuration, traffic mix, metric, check (with what it
captures) or set of weights is a new file and a new entry; no file here
changes.
"""

from __future__ import annotations

import importlib
import json
import pkgutil
from dataclasses import dataclass
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent
# every number harness/judge.py `readings` forms (named here so that set-up
# can sort a cell's limits without importing the judge's references)
JUDGE_NUMBERS = ("odom_gap_rms_m", "odom_gap_max_m", "rpe_max_m",
                 "graph_gap_m", "imu_guess_gap_m", "deskew_gap_m",
                 "front_ate_m", "loop_ate_m")


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list
    run_seconds: int


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    with open(root / cfg_entry["file"]) as f:
        config = json.load(f)
    with open(BENCH_DIR / "traffic" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    with open(BENCH_DIR / "limits" / f"{name}.json") as f:
        limits = json.load(f)
    return Cell(
        name=name, chips=int(w["chips"]), config=config, traffic=traffic,
        limits=limits,
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
        run_seconds=int(bench["run_seconds"]))


def metric_reader(name: str):
    """perfbench/metrics/<name>.py's `read`."""
    return importlib.import_module(f"perfbench.metrics.{name}").read


def check_modules() -> dict:
    """Every perfbench/checks/<check>.py, by name."""
    from perfbench import checks

    return {m.name: importlib.import_module(f"perfbench.checks.{m.name}")
            for m in pkgutil.iter_modules(checks.__path__)}


def checks_for(limits: dict) -> dict:
    """{check name: module} of the checks that form the keys of `limits`
    that the judge does not. Raises ValueError that names a key no check
    forms, or one that two checks form."""
    keys = sorted(set(limits) - set(JUDGE_NUMBERS))
    if not keys:
        return {}
    modules = check_modules()
    out = {}
    for key in keys:
        by = sorted(n for n, m in modules.items() if key in m.NUMBERS)
        if len(by) != 1:
            raise ValueError(
                f"limits key {key!r} is formed by "
                + (f"{len(by)} checks {by}" if by else
                   "neither the judge (JUDGE_NUMBERS) nor any "
                   "perfbench/checks/<check>.py"))
        out[by[0]] = modules[by[0]]
    return out


def weights_builder(name: str):
    """perfbench/weights/<name>.py's `build`."""
    return importlib.import_module(f"perfbench.weights.{name}").build
