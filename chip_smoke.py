#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (`greyjack_tpu_torch`) on one
NVIDIA GPU.

    python3 chip_smoke.py                  # what CI / the chip check runs
    python3 chip_smoke.py --profile DIR    # also write a torch.profiler
                                           # breakdown of a short solve

Phases, each fatal on failure:
  1. the card's name and power limit (nvidia-smi);
  2. build the CUDA delta kernel from `greyjack_tpu_torch/csrc/`;
  3. the kernel vs its plain torch version on the card, bit-equal: the four
     output blocks and the i32 delta rows, at n=40 (time windows on / off)
     and at the flagship shape with the port's own sampled neighbourhoods;
  4. `Solver.solve` on the flagship VRP (1000 customers, 8 depots,
     40 vehicles, greedy start, TabuSearch 4096 neighbours, 8 islands,
     200 steps): the kernel's launch count must be > 0, the path
     "int-delta", and the returned score must equal a plain rescore of the
     returned solution, bit for bit;
  5. median kernel time vs plain time at the flagship shape (CUDA events)
     and the solve's scored moves/s.

Prints the kernel table as one JSON line, then, as the last line,
{"ok": true, "device": {...}}. Exits non-zero, printing no result, when no
CUDA device is available or the repository is not beside this script.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

N_CUSTOMERS, N_DEPOTS, K_VEHICLES, SEED = 1000, 8, 40, 37
NEIGHBOURS, TABU_RATE, CHUNK_STEPS, N_ISLANDS = 4096, 0.2, 10, 8
MOVE_PROBAS = [0.5, 0.5, 0.0, 0.0, 0.0, 0.0]
SOLVE_STEPS = 200
DEVICE = "cuda"
KERNEL_SOURCE = "greyjack_tpu_torch/csrc/vrp_delta.cu"
KERNEL_REPLACES = "greyjack_tpu/models/vrp/delta_pallas.py:125"


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError) as e:
        fail(f"nvidia-smi failed: {e}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps=7, inner=10):
    """Median over `reps` of the mean device time of `inner` calls."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times), times


def neighbourhood(req, islands, n, seed):
    """The port's own sampled neighbourhood around each island's base."""
    import torch
    from greyjack_tpu_torch.ops import moves
    from greyjack_tpu_torch.solver.solver import island_generators

    vm = req.variables_manager
    cfg = moves.MoverConfig(vm, TABU_RATE, None, MOVE_PROBAS)
    gens = island_generators(seed, islands, req.device)
    base = torch.stack([vm.sample_variables(g, 1)[0] for g in gens])
    ctx = req.build_base_ctx(base)
    deltas, _ = moves.move_population_delta(gens, base, n, vm, cfg,
                                            cfg.init_tabu_state(islands))
    return ctx, deltas


def compare(name, req, ctx, deltas):
    """Kernel vs plain version on the same inputs; returns max |diff|."""
    import torch
    from greyjack_tpu_torch.models.vrp import delta_kernel as dk

    utils = req._delta_utils()
    inputs, aux = dk._pre(ctx, deltas, utils)
    tw = bool(utils["time_windowed"])
    rows_per_island = inputs[1].shape[0] // aux["n_islands"]
    got = dk._call_kernel(inputs, utils, aux["kd"], aux["n_islands"])
    want = dk._kernel_reference(*inputs, kd=aux["kd"], tw=tw,
                                rows_per_island=rows_per_island)
    torch.cuda.synchronize()
    err = 0
    for block, g, w in zip(("misc", "u", "v", "c"), got, want):
        e = int((g.long() - w.long()).abs().max().item()) if g.numel() else 0
        err = max(err, e)
        if not torch.equal(g, w):
            fail(f"{name}: kernel block {block} differs from the plain "
                 f"version (max |diff| {e})")
    ints_k = dk._post(got, aux, ctx, utils, as_ints=True)
    ints_p = dk._post(want, aux, ctx, utils, as_ints=True)
    if not torch.equal(ints_k, ints_p):
        fail(f"{name}: i32 delta rows differ")
    if ints_k.shape != deltas["positions"].shape[:2] + (3,):
        fail(f"{name}: i32 rows have shape {tuple(ints_k.shape)}")
    print(f"parity {name}: rows={inputs[1].shape[0]} blocks and i32 rows "
          f"bit-equal (max_abs_err {err})", flush=True)
    return err, inputs, aux


def flagship_domain():
    from greyjack_tpu_torch.models.vrp import generate_instance
    return generate_instance(N_CUSTOMERS, N_DEPOTS, K_VEHICLES, seed=SEED,
                             time_windowed=True, device=DEVICE)


def solve_flagship(steps, metrics):
    from greyjack_tpu_torch.agents import TabuSearch
    from greyjack_tpu_torch.agents.termination_strategies import StepsLimit
    from greyjack_tpu_torch.models.vrp import CotwinBuilder, DomainBuilder
    from greyjack_tpu_torch.solver import Solver, SolverLoggingLevels

    agent = TabuSearch(NEIGHBOURS, TABU_RATE, True, None, MOVE_PROBAS,
                       CHUNK_STEPS, StepsLimit(steps - 1))
    return Solver.solve(DomainBuilder.from_generator(flagship_domain),
                        CotwinBuilder(True, True), agent, N_ISLANDS, seed=0,
                        logging_level=SolverLoggingLevels.Silent,
                        metrics=metrics)


def profile(out_dir, n_chunks=3):
    """torch.profiler breakdown of `n_chunks` flagship chunks (after one
    warm-up chunk), with a labelled range around each stage of the step."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, record_function
    from greyjack_tpu_torch.agents import TabuSearch
    from greyjack_tpu_torch.agents.termination_strategies import StepsLimit
    from greyjack_tpu_torch.models.vrp import CotwinBuilder
    from greyjack_tpu_torch.models.vrp import delta_kernel as dk
    from greyjack_tpu_torch.ops import moves
    from greyjack_tpu_torch.parallel import IslandRunner
    from greyjack_tpu_torch.score_calculation.score_requesters import (
        ScoreRequester)
    from greyjack_tpu_torch.solver.solver import island_generators

    def labelled(name, fn):
        def wrapped(*a, **k):
            with record_function(name):
                return fn(*a, **k)
        # the wrapped kernel wrapper counts its launches on this name
        wrapped.launches = getattr(fn, "launches", 0)
        return wrapped

    req = ScoreRequester(CotwinBuilder(True, True).build_cotwin(
        flagship_domain(), False))
    kernel = TabuSearch(NEIGHBOURS, TABU_RATE, True, None, MOVE_PROBAS,
                        CHUNK_STEPS, StepsLimit(10 ** 9)).build_kernel(req)
    runner = IslandRunner(kernel, N_ISLANDS, CHUNK_STEPS)
    stages = [(moves, "move_population_delta", "step.sample"),
              (dk, "_pre", "step.score._pre"),
              (dk, "_call_kernel", "step.score.kernel"),
              (dk, "_post", "step.score._post"),
              (req, "update_ctx", "step.update_ctx"),
              (kernel, "prestep", "step.tabu_free"),
              (kernel, "refresh", "chunk.refresh"),
              (runner, "_migrate", "chunk.migrate")]
    saved = [(obj, attr, getattr(obj, attr)) for obj, attr, _ in stages]
    for obj, attr, name in stages:
        setattr(obj, attr, labelled(name, getattr(obj, attr)))
    try:
        gens = island_generators(0, N_ISLANDS, req.device)
        state = runner.init(gens)
        alive = torch.ones(N_ISLANDS, dtype=torch.bool, device=req.device)
        state = runner.run_chunk(state, gens, alive, {}, CHUNK_STEPS)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[
                ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n_chunks):
                state = runner.run_chunk(state, gens, alive, {}, CHUNK_STEPS)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        for obj, attr, fn in saved:
            setattr(obj, attr, fn)
    ka = prof.key_averages()
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "profile_chunks.txt"), "w") as f:
        f.write(ka.table(sort_by="device_time_total", row_limit=60))
    # device busy = kernel and copy time; the labelled ranges also appear
    # on the device timeline, as user annotations spanning their kernels,
    # and are left out (as the profiler's own table totals do)
    dev_ms = sum(e.self_device_time_total for e in ka
                 if e.device_type == DeviceType.CUDA
                 and not e.is_user_annotation) / 1e3
    steps = n_chunks * CHUNK_STEPS
    print(f"profile: {steps} steps wall {wall_ms:.3f} ms "
          f"({wall_ms / steps:.3f} ms/step), device busy {dev_ms:.3f} ms "
          f"({100 * dev_ms / wall_ms:.1f}% of wall)", flush=True)
    for _, _, name in stages:
        rows = [e for e in ka
                if e.key == name and e.device_type == DeviceType.CPU]
        if rows:
            e = rows[0]
            print(f"  {name}: calls {e.count}, host {e.cpu_time_total / 1e3:.3f}"
                  f" ms, device {e.device_time_total / 1e3:.3f} ms", flush=True)


def main(argv):
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs an "
             "NVIDIA GPU")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from greyjack_tpu_torch import cuda_build
        from greyjack_tpu_torch.models.vrp import CotwinBuilder
        from greyjack_tpu_torch.models.vrp import delta_kernel as dk
        from greyjack_tpu_torch.models.vrp import generate_instance
        from greyjack_tpu_torch.score_calculation.score_requesters import (
            ScoreRequester)
        from greyjack_tpu_torch.solver import SolverMetrics
    except ImportError as e:
        fail(f"the port is not importable beside this script: {e}")
    if "jax" in sys.modules:
        fail("the port imported jax")

    card = card_line()
    # the card's name and power limit, exactly as nvidia-smi prints them
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    # --- 1. build ---------------------------------------------------------
    t0 = time.perf_counter()
    dk._library()
    build_s = time.perf_counter() - t0
    info = cuda_build.BUILD_INFO.get("vrp_delta", {})
    ptx = [ln.strip() for ln in info.get("log", "").splitlines()
           if "registers" in ln or "spill" in ln]
    print(f"build: vrp_delta {build_s:.3f} s (nvcc {info.get('seconds', 0):.3f}"
          f" s)", flush=True)
    for ln in ptx:
        print(f"  ptxas: {ln}", flush=True)

    # --- 2. parity ----------------------------------------------------------
    max_err = 0
    for tw in (True, False):
        dom = generate_instance(40, 2, 6, seed=3, time_windowed=tw,
                                device=DEVICE)
        req = ScoreRequester(CotwinBuilder(True, True).build_cotwin(dom,
                                                                    False))
        ctx, deltas = neighbourhood(req, 2, 512, seed=5)
        e, _, _ = compare(f"n40 tw={tw} kd=2", req, ctx, deltas)
        max_err = max(max_err, e)
        # kd=1: the first entry of each move alone is a one-variable change
        one = {k: v[..., :1].contiguous() for k, v in deltas.items()}
        e, _, _ = compare(f"n40 tw={tw} kd=1", req, ctx, one)
        max_err = max(max_err, e)
    freq = ScoreRequester(CotwinBuilder(True, True).build_cotwin(
        flagship_domain(), False))
    ctx, deltas = neighbourhood(freq, N_ISLANDS, NEIGHBOURS, seed=7)
    e, inputs, aux = compare("flagship", freq, ctx, deltas)
    max_err = max(max_err, e)

    # --- 3. the main path ---------------------------------------------------
    metrics = SolverMetrics()
    dk._call_kernel.launches = 0
    t0 = time.perf_counter()
    sol = solve_flagship(SOLVE_STEPS, metrics)
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    launches = dk._call_kernel.launches
    paths = {r["kernel_path"] for r in metrics.records}
    if launches <= 0:
        fail("the solve never launched the CUDA delta kernel")
    if paths != {"int-delta"}:
        fail(f"the solve ran path(s) {paths}, not int-delta")
    steps_run = sum(r["steps"] for r in metrics.records)
    if steps_run < SOLVE_STEPS:
        fail(f"the solve ran {steps_run} steps")
    score = [sol[1]["hard_score"], sol[1]["medium_score"],
             sol[1]["soft_score"]]
    values = torch.tensor([[v for _, v in sol[0]]], dtype=torch.float32,
                          device=DEVICE)
    if values.shape[1] != 2 * N_CUSTOMERS:
        fail(f"solution has {values.shape[1]} values")
    rescore_req = ScoreRequester(CotwinBuilder(True, False).build_cotwin(
        flagship_domain(), False))
    rescored = rescore_req.request_score_plain(values)[0].tolist()
    if not all(map(lambda x: x == x and abs(x) < 1e300, score)):
        fail(f"non-finite score {score}")
    if rescored != score:
        fail(f"solve score {score} != plain rescore {rescored}")
    start_score = rescore_req.request_score_plain(
        rescore_req.variables_manager.initial_values[None])[0].tolist()
    summ = metrics.summary()
    steady = metrics.records[1:]
    steady_mps = (sum(r["moves"] for r in steady)
                  / (sum(r["wall_ms"] for r in steady) / 1e3)) if steady else 0
    print(f"solve: {steps_run} steps x {N_ISLANDS} islands x {NEIGHBOURS} "
          f"neighbours in {solve_s:.3f} s, kernel launches {launches}, path "
          f"int-delta; greedy start {start_score} -> best {score} (= plain "
          f"rescore)", flush=True)
    print(f"solve rate [{card}]: {summ['moves_per_s']:.1f} scored moves/s "
          f"over all chunks, {steady_mps:.1f} excluding the first chunk; "
          f"chunk ms {[r['wall_ms'] for r in metrics.records]}", flush=True)

    # --- 4. timings at the flagship shape -----------------------------------
    utils = freq._delta_utils()
    kd, n_isl = aux["kd"], aux["n_islands"]
    rpi = inputs[1].shape[0] // n_isl
    k_ms, k_all = cuda_ms(lambda: dk._call_kernel(inputs, utils, kd, n_isl))
    p_ms, p_all = cuda_ms(lambda: dk._kernel_reference(
        *inputs, kd=kd, tw=True, rows_per_island=rpi), inner=3)
    print(f"kernel time [{card}] at {inputs[1].shape[0]} rows: "
          f"{k_ms:.4f} ms (runs {[round(t, 4) for t in k_all]}); plain "
          f"torch {p_ms:.4f} ms (runs {[round(t, 4) for t in p_all]})",
          flush=True)

    if "--profile" in argv:
        profile(argv[argv.index("--profile") + 1])

    print(json.dumps({"kernels": [{
        "name": "vrp_delta", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": launches,
        "max_abs_err": max_err, "ms": k_ms, "plain_ms": p_ms}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
