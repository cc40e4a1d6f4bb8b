"""The readers of the port's own spans (`greyjack_tpu_torch/utils/
tracing.py`): each reads a canned trace in which the program's spans sit
inside the ranges the benchmark puts around calls from outside, finds
nothing where its span is missing, and is not moved by an outside range
of a like name; a traced run of every tiny cell reports each of them that
the cell lists."""

import json
import time

import pytest

from gjbench import harness, tracing
from gjbench.tests import _tiny

NEW = ["runner_step_host_ms", "step_launches", "sample_host_ms",
       "delta_score_host_ms", "ctx_update_host_ms",
       "sweep_propose_device_ms", "plain_rescore_device_ms",
       "runner_host_ms", "solver_host_ms"]
OUTSIDE = {"gj.chunk", "gj.step", "gj.sweep", "gj.update_ctx",
           "gj.plain_score"}
# the spans each reader needs (every one of them is read)
NEEDS = {
    "runner_step_host_ms": ["gj.runner.step"],
    "step_launches": ["gj.runner.step"],
    "sample_host_ms": ["gj.moves.sample", "gj.runner.step"],
    "delta_score_host_ms": ["gj.delta.score", "gj.runner.step"],
    "ctx_update_host_ms": ["gj.ctx.update", "gj.runner.step"],
    "sweep_propose_device_ms": ["gj.sweep.propose", "gj.runner.step"],
    "plain_rescore_device_ms": ["gj.score.plain", "gj.runner.step"],
    "runner_host_ms": ["gj.runner.migrate", "gj.runner.reduce",
                       "gj.runner.refresh"],
    "solver_host_ms": ["gj.solver.host", "gj.runner.migrate"],
}


def chrome_trace():
    """The window 0-1000 us: two chunks of two steps. Each step (220 us)
    holds a prestep, the outside "gj.step" and in it the sampler (8 us),
    the delta score (18 us), the sweep proposal inside "gj.sweep", the
    plain score inside "gj.plain_score" and the accept tail with the ctx
    update (36 us) inside "gj.update_ctx"; four kernels a step are launched
    inside the step. After each chunk: migrate, reduce, refresh (10 us
    each, a kernel launched in migrate), then the solver's host section
    (10 + 6 us) with a 4 us read (a copy)."""
    ev = []

    def x(cat, name, ts, dur, **args):
        ev.append({"ph": "X", "cat": cat, "name": name, "ts": ts,
                   "dur": dur, "args": args})

    def user(name, ts, dur):
        x("user_annotation", name, ts, dur)

    def launch(at, op_start, op_dur, corr, name="void k<1>(int)",
               cat="kernel"):
        x("cuda_runtime", "cudaLaunchKernel", at, 3, correlation=corr)
        x(cat, name, op_start, op_dur, correlation=corr)

    user("gj.window", 0, 1000)
    corr = 0
    for c in (0, 500):
        user("gj.chunk", c, 480)
        for s in (c, c + 220):
            user("gj.runner.step", s, 220)
            user("gj.runner.prestep", s + 2, 6)
            user("gj.step", s + 10, 200)
            user("gj.moves.sample", s + 12, 8)
            user("gj.delta.score", s + 22, 18)
            launch(s + 30, s + 31, 5, corr)
            user("gj.sweep", s + 42, 58)
            user("gj.sweep.propose", s + 44, 54)
            launch(s + 50, s + 52, 40, corr + 1)
            user("gj.plain_score", s + 110, 25)
            user("gj.score.plain", s + 112, 21)
            launch(s + 120, s + 121, 30, corr + 2)
            user("gj.agent.accept", s + 140, 65)
            user("gj.update_ctx", s + 150, 40)
            user("gj.ctx.update", s + 152, 36)
            launch(s + 160, s + 161, 2, corr + 3)
            corr += 4
        user("gj.runner.migrate", c + 445, 10)
        launch(c + 450, c + 451, 3, corr)
        user("gj.runner.reduce", c + 455, 10)
        user("gj.runner.refresh", c + 465, 10)
        user("gj.solver.host", c + 482, 10)
        user("gj.solver.sync", c + 483, 4)
        x("cuda_runtime", "cudaMemcpyAsync", c + 484, 2,
          correlation=corr + 1)
        x("gpu_memcpy", "Memcpy DtoH (Device -> Pinned)", c + 485, 1,
          correlation=corr + 1)
        user("gj.solver.host", c + 493, 6)
        corr += 2
    return {"traceEvents": ev}


WANT = {
    "runner_step_host_ms": 0.220,
    "step_launches": 4.0,
    "sample_host_ms": 0.008,
    "delta_score_host_ms": 0.018,
    "ctx_update_host_ms": 0.036,
    "sweep_propose_device_ms": 0.040,
    "plain_rescore_device_ms": 0.030,
    "runner_host_ms": 0.030,
    "solver_host_ms": 0.012,
}


def reduced(chrome):
    return tracing.reduce_trace(chrome, 4, {})


def readings(trace):
    return {name: harness.reader(name).read(trace) for name in NEW}


def without(chrome, names):
    return {"traceEvents": [e for e in chrome["traceEvents"]
                            if e["name"] not in names]}


def test_every_new_metric_is_in_the_benchmark():
    with open(f"{_tiny.ROOT}/BENCHMARK.json") as f:
        bench = json.load(f)
    entries = {m["name"]: m for m in bench["per_layer"]}
    assert set(NEW) <= set(entries)
    assert list(entries)[-len(NEW):] == NEW
    for name in NEW:
        assert not hasattr(harness.reader(name), "SPANS")
        assert not hasattr(harness.reader(name), "probe")
        assert entries[name]["workloads"]


def test_readers_read_the_canned_trace():
    got = readings(reduced(chrome_trace()))
    assert got == pytest.approx(WANT)


@pytest.mark.parametrize("name", NEW)
def test_a_reader_finds_nothing_without_its_span(name):
    for span in NEEDS[name]:
        trace = reduced(without(chrome_trace(), {span}))
        assert harness.reader(name).read(trace) is None, span


def test_device_readers_find_nothing_without_device_ops():
    chrome = chrome_trace()
    chrome["traceEvents"] = [e for e in chrome["traceEvents"]
                             if e["cat"] not in tracing.DEVICE_CATS]
    got = readings(reduced(chrome))
    for name in ("step_launches", "sweep_propose_device_ms",
                 "plain_rescore_device_ms"):
        assert got[name] is None
    assert got["runner_step_host_ms"] == pytest.approx(0.22)


def test_outside_ranges_move_no_reading():
    """The ranges put from outside, and further outside ranges named like
    the program's spans but not the same, leave every reading as it is."""
    bare = readings(reduced(without(chrome_trace(), OUTSIDE)))
    assert bare == pytest.approx(WANT)
    chrome = chrome_trace()
    for e in list(chrome["traceEvents"]):
        if e["name"].startswith("gj.") and e["name"].count(".") == 2:
            like = e["name"].rsplit(".", 1)[0]           # gj.runner, ...
            chrome["traceEvents"].append(dict(e, name=like))
            chrome["traceEvents"].append(dict(e, name=e["name"] + "s"))
    assert readings(reduced(chrome)) == pytest.approx(WANT)


def test_the_outside_twins_read_alike():
    """On the canned trace the twins and the outside metrics they sit
    beside: the same device time, and the ctx update inside its range."""
    trace = reduced(chrome_trace())

    def read(name):
        return harness.reader(name).read(trace)

    assert read("sweep_propose_device_ms") == pytest.approx(
        read("sweep_device_ms"))
    assert read("plain_rescore_device_ms") == pytest.approx(
        read("plain_score_device_ms"))
    assert read("ctx_update_host_ms") <= read("update_ctx_host_ms")
    assert read("runner_step_host_ms") >= read("step_host_ms")


def _listed(root, cell):
    """The new metrics `cell` lists, and each metric's source."""
    with open(f"{root}/BENCHMARK.json") as f:
        bench = json.load(f)
    names = harness.cell_metrics(bench, cell, True)
    sources = {m["name"]: m["source"] for m in bench["per_layer"]}
    return [n for n in NEW if n in names], sources


@pytest.mark.parametrize("cell", sorted(_tiny.CELLS))
def test_traced_tiny_cells_report_the_program_spans(tiny_root, cell):
    """On the CPU every listed metric read from host spans is reported
    (those read from device ops have none to read here)."""
    listed, sources = _listed(tiny_root, cell)
    assert listed
    result, _ = harness.run(tiny_root, cell, 2 ** 33 + 17, 600.0, True,
                            "cpu", time.perf_counter())
    assert result["correct"], result["checks"]
    for name in listed:
        if sources[name] == "program_span":
            assert result["metrics"][name]["value"] > 0, name


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(_tiny.CELLS))
def test_traced_tiny_cells_report_every_new_metric_on_the_card(
        tiny_root, card, cell):
    listed, _ = _listed(tiny_root, cell)
    result, _ = harness.run(tiny_root, cell, 2 ** 33 + 17, 600.0, True,
                            card, time.perf_counter())
    assert result["correct"], result["checks"]
    for name in listed:
        assert result["metrics"][name]["value"] > 0, name
