"""One run of one cell: the instance from the seed, a warm-up solve, the
timed solve through `greyjack_tpu_torch.solver.Solver.solve`, the metrics,
and the check that decides `correct`.

Everything that belongs to one configuration, cell or metric is found by
name: `BENCHMARK.json` names the cell, its configuration file and its
metrics; the cell's agent and traffic are `gjbench/workloads/<cell>.json`;
the configuration's family (instance draws, hand-over to the port,
reference view) is `gjbench/families/<family>.py`; each metric is read by
`gjbench/metrics/<metric>.py`. The timed solve runs as a user's does
(`metrics=None`, no extra synchronisation) under a `TimeSpentLimit`; the
harness times it from its own wrapper around `IslandRunner.run_chunk`.
"""

from __future__ import annotations

import contextlib
import importlib
import json
import os
import time

import numpy as np


def load(root, cell):
    """(benchmark, cell entry, configuration, workload) of cell `cell`."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    entry = next((w for w in bench["workloads"] if w["name"] == cell), None)
    if entry is None:
        raise KeyError(f"no cell {cell!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    with open(os.path.join(root, conf["file"])) as f:
        config = json.load(f)
    with open(os.path.join(root, "gjbench", "workloads", cell + ".json")) as f:
        workload = json.load(f)
    if (workload["config"], workload["traffic"]) != (entry["config"],
                                                     entry["traffic"]):
        raise ValueError(f"{cell}: the workload file names "
                         f"{workload['config']} / {workload['traffic']}")
    return bench, entry, config, workload


def cell_metrics(bench, cell, trace):
    """Names of the metrics a run of `cell` reports: the end-to-end ones
    (trace 0) or the per-layer ones (trace 1), as BENCHMARK.json lists
    them for the cell."""
    e2e = [m["name"] for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    return [m["name"] for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in e2e)]


def reader(name):
    return importlib.import_module(f"gjbench.metrics.{name}")


def seeds(seed):
    """(instance generator, solver seed, check generator) from --seed, any
    whole number."""
    kids = np.random.SeedSequence(seed % (1 << 64)).spawn(3)
    solver_seed = int(kids[1].generate_state(1, np.uint64)[0] >> np.uint64(1))
    return (np.random.default_rng(kids[0]), solver_seed,
            np.random.default_rng(kids[2]))


def agent(workload, termination):
    from greyjack_tpu_torch import agents
    return getattr(agents, workload["agent"])(
        **workload["agent_args"], migration_frequency=workload["chunk_steps"],
        termination_strategy=termination)


class ChunkClock:
    """Wraps `IslandRunner.run_chunk`: the host time of every entry, the
    kernel's path, and the hooks of the observed step and the tracer."""

    def __init__(self, patch, capture, tracer=None):
        import torch

        from greyjack_tpu_torch.parallel import IslandRunner

        self.entries = []
        self.path = None
        run_chunk = IslandRunner.run_chunk
        clock = self

        def timed(runner, *a, **k):
            idx = len(clock.entries)
            clock.entries.append(time.perf_counter())
            if idx == 0:
                clock.path = runner.kernel.path
                capture.arm(runner)
            span = contextlib.nullcontext()
            if tracer is not None:
                tracer.on_chunk(idx, runner)
                span = torch.profiler.record_function("gj.chunk")
            try:
                with span:
                    return run_chunk(runner, *a, **k)
            finally:
                if idx == 0:
                    capture.disarm()

        patch.set(IslandRunner, "run_chunk", timed)


def execute(root, cell, seed, seconds, trace, device, t_start):
    """Set-up, warm-up and the timed solve of one run; returns what
    `finish` reports and judges."""
    import torch

    from gjbench import check, tracing
    from greyjack_tpu_torch.agents.termination_strategies import (
        StepsLimit, TimeSpentLimit)
    from greyjack_tpu_torch.solver import Solver, SolverLoggingLevels

    bench, entry, config, workload = load(root, cell)
    family_mod = importlib.import_module(
        f"gjbench.families.{config['family']}")
    rng_inst, solver_seed, rng_check = seeds(seed)
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.cuda.init()
    inst = family_mod.make_instance(config, rng_inst)
    domain_builder, cotwin_builder = family_mod.builders(inst, workload,
                                                         device)
    precision = workload.get("score_precision")
    steps = workload["chunk_steps"]

    def solve(termination, seed_):
        return Solver.solve(domain_builder, cotwin_builder,
                            agent(workload, termination),
                            workload["islands"], score_precision=precision,
                            logging_level=SolverLoggingLevels.Silent,
                            seed=seed_)

    # warm-up: two chunks of the cell's own shapes
    solve(StepsLimit(2 * steps - 1), solver_seed)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)

    names = cell_metrics(bench, cell, trace)
    patch = check.Patch()
    tracer = None
    if trace:
        tracer = tracing.Tracer([reader(n) for n in names], patch, device)
        tracer.install()
    capture = check.Capture(family_mod.Family, workload, rng_check)
    clock = ChunkClock(patch, capture, tracer)
    # a traced run ends once its profiler window has closed: nothing after
    # it feeds a per-layer metric, and `correct` reads the first chunk and
    # the returned solution
    limit = (StepsLimit(tracing.CHUNKS_NEEDED * steps - 1) if trace
             else TimeSpentLimit(int(seconds * 1000)))
    try:
        solution = solve(limit, solver_seed)
        t_end = time.perf_counter()
    finally:
        if tracer is not None:
            tracer.close()
        patch.close()
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    entries = clock.entries
    if len(entries) < 2:
        raise RuntimeError(f"{cell}: the timed solve ran {len(entries)} "
                           "chunk(s); the window needs two or more")
    cycles = [b - a for a, b in zip(entries[1:], entries[2:] + [t_end])]
    final_score = [float(solution[1][k]) for k in family_mod.SCORE_NAMES]
    return {
        "bench": bench, "cell": cell, "config": config, "workload": workload,
        "family_mod": family_mod, "inst": inst, "device": device,
        "names": names, "tracer": tracer, "capture": capture.data,
        "path": clock.path, "peak": peak,
        "final_row": np.asarray([v for _, v in solution[0]], np.int64),
        "final_score": final_score,
        "layout": family_mod.layout([n for n, _ in solution[0]]),
        "record": {"setup_s": entries[0] - t_start, "cycles_s": cycles,
                   "window_s": t_end - entries[1],
                   "window_chunks": len(cycles), "final_score": final_score,
                   "config": config, "workload": workload}}


def family(st, precision="float64"):
    """The reference side of a run's instance."""
    return st["family_mod"].Family(st["inst"], st["device"], st["layout"],
                                   precision)


def finish(st):
    """The result dict of one run (`correct`, `attempted`, `failed`,
    `metrics`, `device`, and `breakdown` when traced; `checks` last), and
    a few facts for the log."""
    import torch

    from gjbench import check, tracing

    device, bench = st["device"], st["bench"]
    # the check: the reference side, after the window and the peak
    numbers = check.judge(family(st), st["capture"], st["final_row"],
                          st["final_score"], st["workload"], device)
    numbers["path_bad"] = {"value": int(st["path"] != st["workload"]["path"]),
                           "limit": check.LIMITS["path_bad"]}
    metrics = {}
    breakdown = reduced = None
    units = {m["name"]: m["unit"]
             for m in bench["end_to_end"] + bench["per_layer"]}
    if st["tracer"] is not None:
        reduced = st["tracer"].read()
        if reduced is not None:
            for name in st["names"]:
                value = reader(name).read(reduced)
                if value is not None:
                    metrics[name] = {"value": value, "unit": units[name]}
            breakdown = tracing.breakdown(reduced)
    else:
        for name in st["names"]:
            value = reader(name).read(st["record"])
            if value is not None:
                metrics[name] = {"value": value, "unit": units[name]}

    failed = sum(1 for v in numbers.values() if v["value"] > v["limit"])
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": int(st["peak"])}
    if reduced is not None:
        dev["busy_s"] = tracing.busy_us(reduced) / 1e6
        dev["window_s"] = tracing.window_us(reduced) / 1e6
    result = {"correct": failed == 0, "attempted": len(numbers),
              "failed": failed, "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = numbers
    info = {"chunks": len(st["record"]["cycles_s"]) + 1,
            "window_s": st["record"]["window_s"],
            "final_score": st["final_score"], "path": st["path"]}
    return result, info


def run(root, cell, seed, seconds, trace, device, t_start):
    """One run: `finish(execute(...))`."""
    return finish(execute(root, cell, seed, seconds, trace, device, t_start))
