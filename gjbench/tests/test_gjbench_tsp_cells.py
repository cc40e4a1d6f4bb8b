"""The TSP cells `tsp-n1000.ts-random` (the f64 delta path's own checks,
`gjbench/paths/delta.py`) and `tsp-e10k.ts-sweep` (the Challenge's 10^6
square) at test sizes on the CPU: every number at 0 for the program, and
over a limit for the float32 control or a planted fault; and the readers
`sweep_families_device_ms` and `winner_apply_device_ms` on a canned
trace."""

import json
import os
import time

import pytest
import torch

from gjbench import check, control, harness, tracing
from gjbench.tests import _tiny

CONFIGS = {
    "tsp-e-tiny": {"family": "tsp", "n_locations": 60, "span": 1e6},
}
RANDOM = {
    "agent_args": {"neighbours_count": 64, "tabu_entity_rate": 0.5,
                   "compare_to_global": True,
                   "mutation_rate_multiplier": None,
                   "move_probas": [0.0, 0.2, 0.2, 0.2, 0.2, 0.2]},
    "score_precision": [3, 3],
    "cotwin": {"incremental": True, "greedy": True},
    "path": "delta", "moves": "neighbours",
    "check": {"sample": 16, "accept": "tabu"}}
CELLS = {
    "tsp-tiny.ts-random": ("tsp-tiny", RANDOM),
    "tsp-1k.ts-random": ("tsp-1k", RANDOM),
    "tsp-e-tiny.ts-sweep": ("tsp-e-tiny",
                            _tiny.CELLS["tsp-tiny.ts-sweep"][1]),
}
SEED = 2 ** 33 + 29


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """The tiny cells of `_tiny.py` and these, in one checkout-like
    directory."""
    path = _tiny.make_root(str(tmp_path_factory.mktemp("tsp")))
    with open(os.path.join(path, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for name, cfg in CONFIGS.items():
        file = f"gjbench/configs/{name}.json"
        with open(os.path.join(path, file), "w") as f:
            json.dump({"name": name, **cfg}, f)
        bench["configs"].append({"name": name, "source": "test",
                                 "file": file, "reduced": [], "why": "test"})
    for cell, (config, wl) in CELLS.items():
        traffic = cell.split(".", 1)[1]
        wl = {"config": config, "traffic": traffic, "agent": "TabuSearch",
              "islands": 2, "chunk_steps": 3, **wl}
        with open(os.path.join(path, "gjbench", "workloads",
                               cell + ".json"), "w") as f:
            json.dump(wl, f)
        bench["workloads"].append({"name": cell, "config": config,
                                   "traffic": traffic, "chips": 1,
                                   "why": "test"})
    for m in bench["per_layer"]:
        if m["name"] in ("sweep_families_device_ms",
                         "winner_apply_device_ms"):
            m["workloads"].append("tsp-e-tiny.ts-sweep")
    with open(os.path.join(path, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return path


def over(numbers):
    return {k for k, v in numbers.items() if v > check.LIMITS[k]}


@pytest.mark.parametrize("cell", ["tsp-tiny.ts-random",
                                  "tsp-e-tiny.ts-sweep"])
def test_the_program_reads_zero(root, cell):
    result, info = harness.run(root, cell, SEED, 0.5, False, "cpu",
                               time.perf_counter())
    assert result["correct"], result["checks"]
    assert info["path"] == CELLS[cell][1]["path"]
    want = {"final_score_gap", "not_improved", "capture_missing",
            "state_bad", "cand_bad", "winner_bad", "ctx_bad", "path_bad"}
    assert set(result["checks"]) == want
    assert {"moves_per_s", "chunk_ms_p90", "setup_s"} <= set(
        result["metrics"])


@pytest.mark.parametrize("seed", [101, 2 ** 31 + 103])
def test_the_control_fails_on_the_delta_path(root, seed):
    got = control.readings(root, "tsp-1k.ts-random", seed, 0.5, "cpu")
    assert not over(got["program"]), got
    assert "cand_bad" in over(got["control"]), got


@pytest.mark.parametrize("fault", ["row", "winner"])
def test_a_planted_fault_shows_on_the_delta_path(root, fault, monkeypatch):
    """Each neighbour's row off by one thousandth, or only the row the
    step picks: the check reads cand_bad, or winner_bad."""
    from greyjack_tpu_torch.score_calculation.score_requesters import (
        ScoreRequester)
    score = ScoreRequester.request_score_delta

    def off(self, ctx, deltas):
        rows = score(self, ctx, deltas).clone()
        if fault == "row":
            rows[..., 1] += 0.001
        else:
            best = torch.argmin(rows[..., 1], dim=1)
            rows[torch.arange(rows.shape[0]), best, 1] -= 0.001
        return rows

    monkeypatch.setattr(ScoreRequester, "request_score_delta", off)
    result, _ = harness.run(root, "tsp-tiny.ts-random", SEED, 0.5, False,
                            "cpu", time.perf_counter())
    assert not result["correct"]
    bad = {k for k, v in result["checks"].items() if v["value"]}
    assert ("cand_bad" if fault == "row" else "winner_bad") in bad


def test_the_e10k_cell_traces_its_new_metric_spans(root):
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        listed = harness.cell_metrics(json.load(f), "tsp-e-tiny.ts-sweep",
                                      True)
    assert "winner_apply_device_ms" in listed
    result, _ = harness.run(root, "tsp-e-tiny.ts-sweep", SEED, 600.0, True,
                            "cpu", time.perf_counter())
    assert result["correct"], result["checks"]


def chrome_trace():
    """The window 0-1000 us: two steps, each with the four TSP families
    (a kernel of 4, 3, 2 and 1 us), the apply (a 5 us kernel) and the ctx
    update (two 3 us kernels) inside the accept tail; a kernel launched
    in the accept tail outside both."""
    ev = []

    def x(cat, name, ts, dur, **args):
        ev.append({"ph": "X", "cat": cat, "name": name, "ts": ts,
                   "dur": dur, "args": args})

    corr = [0]

    def launch(at, dur):
        corr[0] += 1
        x("cuda_runtime", "cudaLaunchKernel", at, 1, correlation=corr[0])
        x("kernel", "void k<1>(int)", at + 2, dur, correlation=corr[0])

    x("user_annotation", "gj.window", 0, 1000)
    for s in (0, 400):
        x("user_annotation", "gj.runner.step", s, 380)
        for i, (fam, dur) in enumerate((("change", 4), ("swap", 3),
                                        ("two_opt", 2), ("or_opt", 1))):
            x("user_annotation", f"gj.sweep.{fam}", s + 10 + 40 * i, 30)
            launch(s + 12 + 40 * i, dur)
        x("user_annotation", "gj.agent.accept", s + 200, 150)
        x("user_annotation", "gj.agent.apply", s + 210, 20)
        launch(s + 212, 5)
        x("user_annotation", "gj.ctx.update", s + 240, 60)
        launch(s + 242, 3)
        launch(s + 262, 3)
        launch(s + 320, 7)
    return {"traceEvents": ev}


def test_the_readers_read_the_canned_trace():
    trace = tracing.reduce_trace(chrome_trace(), 2, {})
    fams = harness.reader("sweep_families_device_ms")
    apply = harness.reader("winner_apply_device_ms")
    assert fams.read(trace) == pytest.approx(0.010)
    assert apply.read(trace) == pytest.approx(0.011)


@pytest.mark.parametrize("span", ["gj.agent.apply", "gj.ctx.update",
                                  "gj.sweep.or_opt", "gj.runner.step"])
def test_the_readers_find_nothing_without_their_spans(span):
    chrome = chrome_trace()
    chrome["traceEvents"] = [e for e in chrome["traceEvents"]
                             if e["name"] != span]
    trace = tracing.reduce_trace(chrome, 2, {})
    fams = harness.reader("sweep_families_device_ms").read(trace)
    apply = harness.reader("winner_apply_device_ms").read(trace)
    if span.startswith("gj.sweep") or span == "gj.runner.step":
        assert fams is None
    if not span.startswith("gj.sweep"):
        assert apply is None
