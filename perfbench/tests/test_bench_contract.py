"""BENCHMARK.json and the files it names: discovery by name, the
contract's keys, names and units, and the imports of every module."""

import ast
import importlib
import json
import re
from pathlib import Path

import pytest

from perfbench.harness import spec

ROOT = spec.ROOT
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_entries_have_just_their_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file()
        assert c["file"].startswith("perfbench/")
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
        assert len(w["why"]) <= 200 and "\n" not in w["why"]
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_names_and_units():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append((group in ("end_to_end", "per_layer"), e["name"]))
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
    metrics = [n for is_m, n in names if is_m]
    assert len(metrics) == len(set(metrics))
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_is_found_by_name(cell):
    c = spec.load_cell(cell)
    from perfbench.harness import program

    assert callable(program.sessions_for(c.traffic["session"]))
    importlib.import_module(f"perfbench.worlds.{c.traffic['world']}")
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert m["moves"] in e2e
        assert callable(spec.metric_reader(m["name"]))
    assert c.limits and all(v > 0 for v in c.limits.values())


def test_setup_bound():
    setup = [m for m in BENCH["end_to_end"] if m["name"] == "setup_s"]
    assert len(setup) == 1 and setup[0]["bound"] <= 0.25


def test_configs_repeat_the_built_configuration():
    from perfbench.harness import program

    for c in BENCH["configs"]:
        config = json.loads((ROOT / c["file"]).read_text())
        assert config["name"] == c["name"]
        program.build_config(config)  # raises where a size disagrees


def test_percentages_and_ratios_have_units():
    for m in BENCH["per_layer"]:
        if m["name"].endswith("_roofline") or m["name"].endswith("_idle"):
            assert m["unit"] == "%"


FORBIDDEN = {"jax", "jaxlib", "flax", "lis_slam_tpu"}


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0]


def test_nothing_imports_jax_or_the_jax_package():
    files = sorted((ROOT / "perfbench").rglob("*.py"))
    assert files
    for f in files:
        bad = set(_imports(f)) & FORBIDDEN
        assert not bad, f"{f}: {bad}"


YARDSTICK = ["harness/render.py", "harness/drift.py", "harness/bounds.py",
             "harness/stats.py", "harness/traffic.py"]


def test_the_reference_and_yardstick_import_nothing_of_the_program():
    files = sorted((ROOT / "perfbench" / "reference").rglob("*.py")) + [
        ROOT / "perfbench" / f for f in YARDSTICK]
    for f in files:
        bad = set(_imports(f)) & (FORBIDDEN | {"lis_slam_torch"})
        assert not bad, f"{f}: {bad}"
    # the name check compares whole top-level names: the port's name
    # begins with the JAX package's and is not it
    assert "lis_slam_torch".split(".")[0] not in FORBIDDEN


def test_every_limits_key_is_formed_by_the_judge_or_a_check():
    files = sorted((ROOT / "perfbench" / "limits").glob("*.json"))
    assert {f.stem for f in files} >= set(CELLS)
    for f in files:
        # raises on a key that nothing forms
        spec.checks_for(json.loads(f.read_text()))
    for name, check in spec.check_modules().items():
        assert check.NUMBERS, name
        assert not set(check.NUMBERS) & set(spec.JUDGE_NUMBERS), name
        for module, attr in check.CAPTURES:
            assert hasattr(importlib.import_module(module), attr), name
        for fn in ("keep", "readings", "control"):
            assert callable(getattr(check, fn)), (name, fn)
