"""The `gj.*` spans of `greyjack_tpu_torch/utils/tracing.py` through whole
solves on the CPU: the VRP sweep, the TSP sweep, the VRP int-delta path
(the fused kernel's CPU reference route) and the VRP plain path.

For each solve: with no profiler running the helper never enters
`record_function` (the reference it calls raises here), and still hands
out its null context; under `torch.profiler` the Chrome trace holds every
span of the path, each inside the parent it is listed under, with one
`gj.runner.step` a step run; and the returned solution is the same, bit
for bit, with the profiler on and off."""

import json

import pytest
import torch

from greyjack_tpu_torch.agents import TabuSearch
from greyjack_tpu_torch.agents.termination_strategies import StepsLimit
from greyjack_tpu_torch.models import tsp
from greyjack_tpu_torch.models.vrp import (CotwinBuilder, DomainBuilder,
                                           generate_instance)
from greyjack_tpu_torch.solver import Solver, SolverLoggingLevels
from greyjack_tpu_torch.utils import tracing

torch.set_num_threads(1)

_STEPS = 3          # steps a chunk
_CHUNKS = 2
_VRP_MOVES = [0.5, 0.5, 0.0, 0.0, 0.0, 0.0]

# span -> the span it sits in (None: inside no other program span)
_COMMON = {
    "gj.solver.host": None,
    "gj.solver.sync": "gj.solver.host",
    "gj.runner.step": None,
    "gj.runner.migrate": None,
    "gj.runner.reduce": None,
    "gj.runner.refresh": None,
    "gj.agent.accept": "gj.runner.step",
}
_CTX = {
    "gj.runner.prestep": "gj.runner.step",
    "gj.ctx.update": "gj.agent.accept",
    "gj.ctx.build": "gj.runner.refresh",
}
_SWEEP = {
    **_COMMON, **_CTX,
    "gj.agent.propose": "gj.runner.step",
    "gj.sweep.propose": "gj.agent.propose",
    "gj.sweep.targets": "gj.sweep.propose",
    "gj.sweep.tables": "gj.sweep.propose",
    "gj.sweep.change": "gj.sweep.propose",
    "gj.sweep.swap": "gj.sweep.propose",
    "gj.sweep.select": "gj.sweep.propose",
    "gj.sweep.exact": "gj.sweep.propose",
}
PATHS = {
    "vrp-sweep": {**_SWEEP, "gj.sweep.vehicle": "gj.sweep.propose"},
    "tsp-sweep": {**_SWEEP, "gj.sweep.two_opt": "gj.sweep.propose",
                  "gj.sweep.or_opt": "gj.sweep.propose"},
    "vrp-intdelta": {
        **_COMMON, **_CTX,
        "gj.moves.sample": "gj.runner.step",
        "gj.delta.score": "gj.runner.step",
        "gj.delta.pre": "gj.delta.score",
        "gj.delta.kernel": "gj.delta.score",
        "gj.delta.post": "gj.delta.score",
    },
    "vrp-plain": {
        **_COMMON,
        "gj.moves.sample": "gj.runner.step",
        "gj.score.plain": "gj.runner.step",
    },
}
KERNEL_PATH = {"vrp-sweep": "sweep", "tsp-sweep": "sweep",
               "vrp-intdelta": "int-delta", "vrp-plain": "plain"}


def _vrp():
    return DomainBuilder.from_generator(
        lambda: generate_instance(30, 2, 5, seed=3, time_windowed=True,
                                  device="cpu"))


def solve(path):
    """The returned solution and the kernel's path of a small solve of
    `_CHUNKS` chunks."""
    limit = StepsLimit(_CHUNKS * _STEPS - 1)
    precision = None
    if path == "tsp-sweep":
        db = tsp.DomainBuilder.from_generator(
            lambda: tsp.generate_uniform_instance(24, seed=11, device="cpu"))
        cb = tsp.CotwinBuilder(True, True)
        agent = TabuSearch(64, 0.5, True, None, [0.0, 0.2, 0.2, 0.2, 0.2, 0.2],
                           _STEPS, limit, sweep=True, sweep_targets=8)
        precision = [3, 3]
    elif path == "vrp-sweep":
        db, cb = _vrp(), CotwinBuilder(True, True)
        agent = TabuSearch(64, 0.2, True, None, _VRP_MOVES, _STEPS, limit,
                           sweep=True, sweep_targets=8, sweep_window=4)
    elif path == "vrp-intdelta":
        db, cb = _vrp(), CotwinBuilder(True, True)
        agent = TabuSearch(64, 0.2, True, None, _VRP_MOVES, _STEPS, limit)
    else:
        db, cb = _vrp(), CotwinBuilder(False, True)
        agent = TabuSearch(32, 0.2, True, None, None, _STEPS, limit)
    kernel_path = []
    build = agent.build_kernel

    def recorded(*a, **k):
        kernel = build(*a, **k)
        kernel_path.append(kernel.path)
        return kernel

    agent.build_kernel = recorded
    sol = Solver.solve(db, cb, agent, 2, score_precision=precision,
                       logging_level=SolverLoggingLevels.Silent, seed=7)
    return sol, kernel_path[0]


def profiled(path, tmp_path):
    """(solution, [(name, start_us, end_us)] of the gj.* spans) of a solve
    under the CPU profiler."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        sol, _ = solve(path)
    out = tmp_path / "trace.json"
    prof.export_chrome_trace(str(out))
    with open(out) as f:
        events = json.load(f)["traceEvents"]
    spans = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
             for e in events if e.get("ph") == "X"
             and e.get("cat") == "user_annotation"
             and e.get("name", "").startswith("gj.")]
    return sol, spans


def parent(span, spans):
    """The innermost other span that holds `span`, or None."""
    _, s, e = span
    holders = [o for o in spans if o is not span and o[1] <= s and e <= o[2]
               and (o[1], o[2]) != (s, e)]
    return min(holders, key=lambda o: o[2] - o[1])[0] if holders else None


@pytest.mark.parametrize("path", sorted(PATHS))
def test_no_profiler_no_record_function(path, monkeypatch):
    entered = []

    class Counting:
        def __enter__(self):
            entered.append(1)

        def __exit__(self, *exc):
            return False

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) without a profiler")

    monkeypatch.setattr(tracing, "record_function", refuse)
    monkeypatch.setattr(tracing, "_OFF", Counting())
    sol, kernel_path = solve(path)
    assert kernel_path == KERNEL_PATH[path]
    assert sol[1]
    # every step of every chunk passed through at least one span
    assert len(entered) >= _CHUNKS * _STEPS


@pytest.mark.parametrize("path", sorted(PATHS))
def test_spans_nest_as_listed(path, tmp_path):
    _, spans = profiled(path, tmp_path)
    want = PATHS[path]
    # before the chunk loop: the islands' first scores and ctx
    loop = min(s for name, s, _ in spans if name == "gj.solver.host")
    setup = {name for name, s, _ in spans if s < loop}
    assert setup <= {"gj.score.plain", "gj.ctx.build"}, setup
    spans = [span for span in spans if span[1] >= loop]
    names = {name for name, _, _ in spans}
    assert set(want) <= names, sorted(set(want) - names)
    # no span of another path, and none of the names the benchmark puts
    # around the port's functions from outside
    assert names <= set(want)
    for span in spans:
        assert parent(span, spans) == want[span[0]], span
    counts = {n: sum(1 for s in spans if s[0] == n) for n in want}
    assert counts["gj.runner.step"] == _CHUNKS * _STEPS
    for name in ("gj.runner.migrate", "gj.runner.reduce",
                 "gj.runner.refresh"):
        assert counts[name] == _CHUNKS
    assert counts["gj.solver.host"] == 2 * _CHUNKS


@pytest.mark.parametrize("path", sorted(PATHS))
def test_profiler_leaves_the_solution_unchanged(path, tmp_path):
    traced, _ = profiled(path, tmp_path)
    plain, _ = solve(path)
    assert traced == plain
