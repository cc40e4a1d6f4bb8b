"""Every file BENCHMARK.json names is there, loads, and agrees with it; the
file keeps to the benchmark's contract."""

import importlib
import json
import os
import re

import pytest

from gjbench import check, harness
from gjbench.metrics import _moves

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
with open(os.path.join(ROOT, "BENCHMARK.json")) as _f:
    BENCH = json.load(_f)
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_top_level_keys_and_sizes():
    assert list(BENCH) == ["command", "paths", "run_seconds", "configs",
                           "workloads", "end_to_end", "per_layer"]
    assert BENCH["command"] == ["python3", "gjbench/run.py"]
    assert BENCH["paths"] == ["gjbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) < 64 * 1024
    # a full check of 24 cells fits its 43,200 seconds
    runs = 2 + 14 * 24
    assert (runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200) <= 43200


@pytest.mark.parametrize("cell", CELLS)
def test_cell_loads(cell):
    bench, entry, config, workload = harness.load(ROOT, cell)
    assert entry["chips"] == 1
    assert len(entry["why"]) <= 200 and NAME.match(cell)
    importlib.import_module(f"gjbench.families.{config['family']}")
    # a path's own checks, where it has a file, and the acceptance and
    # moves rules, each found by name
    path = check.path_module(workload["path"])
    assert path is None or all(callable(getattr(path, f)) for f in (
        "observe", "reduce", "judge"))
    assert callable(check.accept_rule(workload["check"]["accept"]).keeps)
    assert isinstance(_moves.per_island_step(config, workload), int)
    names = harness.cell_metrics(bench, cell, False)
    assert "setup_s" in names and len(names) >= 2
    assert harness.cell_metrics(bench, cell, True)


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(conf):
    with open(os.path.join(ROOT, conf["file"])) as f:
        cfg = json.load(f)
    assert cfg["name"] == conf["name"] and NAME.match(conf["name"])
    assert cfg["reduced"] == conf["reduced"]
    assert cfg["source"] and len(conf["source"]) <= 200
    assert conf["file"].startswith("gjbench/")
    assert any(w["config"] == conf["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("name", METRICS)
def test_metric_reader(name):
    mod = harness.reader(name)
    assert callable(mod.read)
    assert NAME.match(name)


def test_metric_entries():
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
    setup = next(m for m in BENCH["end_to_end"] if m["name"] == "setup_s")
    assert setup["bound"] <= 0.25
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    layers = {}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and m["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock")
        assert set(m["workloads"]) <= set(CELLS)
        assert "\n" not in m["layer"] and len(m["layer"]) <= 200
        layers.setdefault(m["layer"], []).append(m["name"])
    assert len(METRICS) == len(set(METRICS))
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"])
        assert m["better"] in ("lower", "higher")


def test_every_cell_reports_a_per_layer_metric_of_its_own():
    for cell in CELLS:
        e2e = harness.cell_metrics(BENCH, cell, False)
        for name in harness.cell_metrics(BENCH, cell, True):
            m = next(x for x in BENCH["per_layer"] if x["name"] == name)
            assert m["moves"] in e2e


def test_paths_hold_only_the_benchmark():
    for path in BENCH["paths"]:
        assert not path.endswith("_torch") and os.path.isdir(
            os.path.join(ROOT, path))
