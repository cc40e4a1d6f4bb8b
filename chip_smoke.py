#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (`greyjack_tpu_torch`) on one
NVIDIA GPU.

    python3 chip_smoke.py                  # what CI / the chip check runs
    python3 chip_smoke.py --profile DIR    # also write torch.profiler
                                           # breakdowns of short solves
                                           # (int-delta, sweep, LA-random,
                                           # GA, TS-plain, LA-plain, LSHADE,
                                           # mixed-int LSHADE, TSP sweep)

Phases, each fatal on failure:
  1. the card's name and power limit (nvidia-smi);
  2. build the CUDA delta kernel from `greyjack_tpu_torch/csrc/`, printing
     ptxas's registers, spills and shared memory for every instantiation;
  3. the kernel vs its plain torch version on the card, bit-equal: the four
     output blocks and the i32 delta rows, on both kernel routes (the
     shared route at n=40 with 2 islands x 512 neighbours, the direct
     route with 2 x 1; time windows on / off; kd 2 / 1; a route that
     fills Rp = 128 at n=128; and one that fills Rp = 384 at n=300, on the
     direct route at both neighbour counts), and at the flagship shape,
     which must take the shared route, and the 512 x 1 shape, which must
     take the direct one, with the port's own sampled neighbourhoods;
  4. `Solver.solve` on the flagship VRP (1000 customers, 8 depots,
     40 vehicles, greedy start, TabuSearch 4096 neighbours, 8 islands,
     200 steps): the kernel's launch count must be > 0, the path
     "int-delta", and the returned score must equal a plain rescore of the
     returned solution, bit for bit;
  5. the kernel's time at the flagship and the 512 x 1 shapes: device only
     (a CUDA graph of raw launches on preallocated outputs), with the
     wrapper (`_call_kernel`, CUDA events) and its plain version's, beside
     its bound; and the solve's scored moves/s;
  6. the VRP sweep neighbourhood (plain torch ops, no kernel of its own)
     on the card vs on the CPU, bit-equal: the stop table and route grids,
     every candidate family array and the deterministic half of `propose`
     (winner delta, exact row, tabu info, stats), for 2 islands of the
     flagship from perturbed greedy bases, 256 targets, window 16;
  7. `Solver.solve` on the flagship with bench.py's default configuration
     (TabuSearch sweep, 256 targets, 8 islands, 200 steps): every chunk
     must run path "sweep", the scored-candidate counter must be > 0 and
     the returned score must equal a plain rescore, bit for bit;
  8. LateAcceptance and SimulatedAnnealing on the flagship, in the JAX
     package's per-metaheuristic configurations (`scripts/bench_mh.py`):
     the sweep forms (8 islands, 64 targets, 200 steps) must run path
     "sweep" with scored candidates > 0, the random-move forms (512
     islands x 1 move, 100 steps) path "delta" with kernel launches > 0
     (the f64 rows of the delta kernel), and every returned score must
     equal a plain rescore, bit for bit;
  9. the generic move library on the card vs on the CPU, bit-equal: the
     port's draws made once on the CPU from a seed, then `do_move`,
     `do_move_delta` and `apply_delta` (wide and narrow) with their tabu
     info for the flagship's variables, 8 islands x 256 candidates, under
     each single move type and the six-equal mix, mutation multiplier
     None and 1.0, tabu on; then the plain sampler kernel
     (`csrc/move_sample.cu`) against the torch body on the card
     (`fix_all(do_move(...))` and the tabu info), fed the same uniforms,
     bit-equal, at TS-plain's shape (8 islands x 2048 candidates, 2,000
     variables, six equal moves, tabu 0.2) on the island's base expanded
     with stride 0 and on a real population off the grid; and its time:
     device only (a CUDA graph of `move_and_fix`), with the wrapper, the
     torch body's and the draw's, beside its byte bound from the run's
     inputs;
 10. the plain score's route-analysis kernel (`csrc/vrp_plain.cu`) against
     the torch body of `build_common` on the same card tensors, at the
     plain cell's shape (16,384 rows of the flagship: TS-plain's 8 x 2048
     one-move candidates of perturbed greedy bases, and random rows):
     `build_common`'s four outputs and the plain score rows bit-equal;
     and its time: device only (a CUDA graph of `route_analysis`), with
     the wrapper, the torch body's, `request_score_plain` both ways,
     beside its byte bound (the id columns and the outputs); then
     the plain path through `Solver.solve` on the flagship: GA (8 islands
     x 128, 200 steps) and GA-wide (64 x 128, 50 steps) with the delta
     cotwin (GA always rescores), TS-plain (8 x 2048, six equal moves, 50
     steps), LA-plain / SA-plain (512 x 1, change / swap, 100 steps)
     without delta kernels, and the six-move TabuSearch on the delta
     cotwin (8 x 2048, kd 16, 50 steps), which must report the JAX
     package's label "int-delta" and score the f64 `score_delta` rows
     with no kernel launch. Each must report its path, and its score must
     equal a plain rescore, bit for bit; TS-, LA- and SA-plain must launch
     the sampler kernel, GA, GA-wide and the six-move delta solve must
     not (nor LSHADE in phase 11); the plain score's kernel must launch
     once for the initial scores and, but in the six-move delta solve,
     once a step (LSHADE in phase 11 too);
 11. LSHADE on the flagship in `scripts/bench_mh.py`'s configuration
     (population 128, archive 128, one forced column, change / swap):
     first one body step on the card vs on the CPU from the same state and
     the same draws (made once on the CPU): integer leaves, population,
     scores, archive and `arc_cr` bit-equal, `arc_f` (through `tan`)
     within 4 ulp, the adaptive memories within a relative 1e-12; then
     LSHADE (8 islands, 200 steps) and LSHADE-wide (64 islands, 50 steps)
     solves: path "plain", no delta-kernel launch, every island's archive
     count <= 128 after every chunk, the score equal to a plain rescore,
     bit for bit;
 12. the mixed-int model (rastrigin, 50 floats + 50 ints, change moves
     only, tabu rate 0): GA, LSHADE and TabuSearch with 128 random
     neighbours, 8 islands x 200 steps each: path "plain", the best below
     the best of the initial populations, and the score equal to a plain
     rescore of the returned solution on the card (bit for bit; where the
     f64 sum over the 100 variables is not, within a relative 1e-12, and
     the line says which held);
 13. `exact_fp_scores=True` on the flagship: the exact plain score of
     1,024 rows on the card equals the CPU's, bit for bit, and so does the
     fast walk's (its time beside the exact fold's); GA (8 x 128, 20
     steps) runs path "plain" and its score equals an exact plain rescore,
     bit for bit;
 14. checkpoint / resume on the int-delta flagship (TabuSearch 4096
     neighbours, 8 islands, 40 steps): a solve stopped when chunk 3's
     metrics land (its checkpoint holds chunks 0-2) and resumed from the
     file ends with the uninterrupted solve's score and values, bit for
     bit; the delta kernel launches in both runs;
 15. the TSP model at n=1000, seed 42 (`examples/tsp_example.py`'s
     instance) on the card vs on the CPU, the same inputs made on the CPU,
     bit-equal: the fast and exact plain scores of 1,024 permutation rows,
     the delta ctx of 8 perturbed greedy tours, the `score_delta` rows of
     an 8 x 1024 six-move neighbourhood, `update_ctx` of full-width
     (reversal) winners, every array of the four sweep families and
     `propose_from_targets`' outputs for 2 islands x 64 targets; then the
     stage times on the card (families, proposal, `update_ctx` of a
     full-width winner, `score_delta`) at 8 islands;
 16. TSP solves through `Solver.solve` at n=1000 (greedy start, 8 islands,
     score_precision [3, 3], tabu rate 0.5): TabuSearch sweep (64
     targets, 200 steps) and LateAcceptance sweep (64 targets, 200 steps)
     must run path "sweep" with scored candidates > 0, TabuSearch random
     (1024 neighbours, five move types, 100 steps) path "delta"; none may
     launch the VRP delta kernel; each must return hard score 0, 999
     unique stops, a tour no longer than the greedy one and a score equal
     to a plain rescore rounded to [3, 3], bit for bit;
 17. N-Queens, 256 queens, seed 45 (`examples/nqueens_example.py`): the
     plain scores of 1,024 rows, the ctx, the `score_delta` rows of 8 x 20
     swap neighbourhoods and `update_ctx` card vs CPU, bit-equal; then
     TabuSearch (20 swap neighbours, tabu 0, 8 islands) to
     ScoreLimit(0), which must run path "delta" and return a board with
     no conflict, and GA (8 x 128, 200 steps), path "plain", no worse than
     the shuffled board;
 18. the mesh on the card: a 1-rank NCCL world (`init_distributed` with a
     `file://` store in a temporary directory); the int-delta flagship
     (4096 neighbours, 8 islands, 200 steps), the sweep flagship (256
     targets, 200 steps) and GA (8 x 128, 50 steps) through
     `Solver.solve(mesh=...)`, each equal to the mesh=None solve of the
     same seed, bit for bit (score, values and every chunk's global best;
     phases 4 and 7 are the int-delta and sweep references), each on its
     path, the int-delta one launching the kernel; their rates beside the
     mesh=None rates and the migration + global-reduce time a chunk (CUDA
     events around `_ring` and `_update_global`) beside the mesh=None
     solves' (phases 4 and 7 carry the same clock);
 19. the partitioned plain score at F = 1 of 1,024 rows of the flagship
     and of the TSP at n=1000, bit-equal to the dense score, both timed;
 20. the service: the flagship's task JSON POSTed to `HttpBroker(port=0)`,
     `SolverService.serve_one` with the sweep TabuSearch (30 steps,
     score_precision [0, 0, 3]); at least one solution streamed over HTTP,
     the final score equal to a rounded plain rescore, "Solving finished"
     published;
 21. native IO: the flagship written as a `.vrp` file and the TSP at
     n=1000 as a `.tsp` file; the g++ tokenizer must build, and its reads
     equal the Python scans and the generated instances; a 20-step
     int-delta solve from `DomainBuilder(vrp_file_path)`, `print_metrics`;
 22. `entry()`'s step on the card equal to the CPU's, and
     `dryrun_multichip(1)` (its three legs) on the 1-rank world.
 23. whole solves against the JAX package, in distribution
     (`tests/_torch_quality.py`, reference rows in
     `tests/torch_quality_ref.json`, made by the JAX package on the CPU
     by `tests/_torch_quality_ref.py`): every configuration there, the
     small ones (the time-windowed VRP at n=60 under TabuSearch sweep /
     int-delta / six-move plain, LateAcceptance and SimulatedAnnealing
     sweep and random, GeneticAlgorithm, LSHADE; the TSP sweep at n=60;
     N-Queens 32; mixed-int GA and LSHADE; 12 seeds each) and the full
     width ones (phases 4 and 7's solves: the flagship int-delta
     TabuSearch, 8 islands x 4096 neighbours x 200 steps, and sweep, 8
     islands x 256 targets x 200 steps; 8 seeds each), solved here with
     the card's generators for the file's seeds: each on its path, the
     int-delta and random-move VRP configurations launching the kernel,
     and a two-sided Mann-Whitney U test of the lexicographic ranks of
     the final scores (and, on the sweep, of the non-converged shares)
     must give p >= 0.01.

Cuts: phases 10-17 run 20-200 steps per solve (widths as configured);
phase 23 runs the reference file's step budgets.

Phases 18-22 need one card. The mesh's collectives run here on a world of
one rank (NCCL refuses two ranks on one GPU): a run over several cards is
not verified by this script, and it claims nothing about one.

Phase 3 also holds the kernel's f64 score rows (`_post` of its blocks)
bit-equal to those of the plain blocks and to the per-neighbour
`score_delta` on the card, and phase 5 also times the kernel at the
random-move shape (512 islands x 1 move x 3 routes = 1,536 rows).

Prints the kernel table as one JSON line, then, as the last line,
{"ok": true, "device": {...}}. Exits non-zero, printing no result, when no
CUDA device is available or the repository is not beside this script.
"""

from __future__ import annotations

import json
import os
import re
import statistics
import subprocess
import sys
import time

N_CUSTOMERS, N_DEPOTS, K_VEHICLES, SEED = 1000, 8, 40, 37
NEIGHBOURS, TABU_RATE, CHUNK_STEPS, N_ISLANDS = 4096, 0.2, 10, 8
MOVE_PROBAS = [0.5, 0.5, 0.0, 0.0, 0.0, 0.0]
SOLVE_STEPS = 200
SWEEP_TARGETS, SWEEP_WINDOW = 256, 16
# LateAcceptance / SimulatedAnnealing as `scripts/bench_mh.py` runs them
LA_SIZE, SA_T0, SA_COOLING = 200, [1000.0, 1000.0, 1.0], 0.9999
MH_TARGETS, RANDOM_ISLANDS, RANDOM_STEPS = 64, 512, 100
# the plain path: GeneticAlgorithm's population, TabuSearch's neighbourhood
GA_POP, PLAIN_NEIGHBOURS = 128, 2048
# LSHADE (population = archive = 128) and the mixed-int model
# (`scripts/bench_mh.py:112-142`, `:177-179`)
LSHADE_POP, MIXED_FLOATS, MIXED_INTS = 128, 50, 50
DEVICE = "cuda"
# the TSP example (`examples/tsp_example.py`) and the N-Queens example
# (`examples/nqueens_example.py`)
TSP_N, TSP_SEED, TSP_TARGETS, TSP_TABU = 1000, 42, 64, 0.5
TSP_NEIGHBOURS, TSP_PRECISION = 1024, [3, 3]
TSP_PROBAS = [0.0, 0.2, 0.2, 0.2, 0.2, 0.2]
NQ_N, NQ_SEED, NQ_NEIGHBOURS = 256, 45, 20
NQ_PROBAS = [0.0, 1.0, 0.0, 0.0, 0.0, 0.0]
KERNEL_SOURCE = "greyjack_tpu_torch/csrc/vrp_delta.cu"
KERNEL_REPLACES = "greyjack_tpu/models/vrp/delta_pallas.py:125"
SAMPLER_SOURCE = "greyjack_tpu_torch/csrc/move_sample.cu"
# no TPU kernel: the JAX package's sampler and fix are XLA ops
SAMPLER_REPLACES = "greyjack_tpu/ops/moves.py:668 (XLA ops)"
PLAIN_SOURCE = "greyjack_tpu_torch/csrc/vrp_plain.cu"
# no TPU kernel: the JAX package's route analysis is XLA ops
PLAIN_REPLACES = "greyjack_tpu/models/vrp/cotwin_builder.py:80 (XLA ops)"
# the plain solves that step through `PlainMoveStep`, so through the
# sampler kernel; GA and LSHADE move their children with the torch body
KERNEL_PLAIN = ("TS-plain", "LA-plain", "SA-plain")


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


def graph_ms(launch, reps=7, inner=20):
    """Device-only time of one launch: a CUDA graph captures `inner` calls
    of `launch` (raw kernel launches on preallocated outputs), and the
    median over `reps` replays of the replay's event time over `inner` is
    returned, with every replay's. No host work is inside the timed span."""
    import torch

    launch()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            launch()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times), times


def raw_launcher(fn, args):
    """A call of the C entry point `fn` with `args` on the current stream
    (inside a capture, the capture's stream); raises on a launch error."""
    import torch

    def launch():
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            fail(f"raw kernel launch failed (cudaError {err})")
    return launch


def kernel_bound(inputs, utils, kd, n_isl):
    """(bytes, operations, bound_ms, bound_by) of one delta-kernel call on
    these inputs: each input byte read once and each output byte written
    once, over the H100's 3.35 TB/s. Of the route table that is, for each
    route the rows name, the slots a row can read (base length + kd + 1,
    at most Rp, from this run's routes) of the tables the function uses
    (six with time windows, three without), in whole 32 B sectors. The
    integer operations on those slots, about 40 i32 operations a slot a
    row, go over the 33.5 TOP/s of its 64 INT32 lanes per SM (half the
    67 TFLOP/s f32 rate)."""
    import torch

    ctx_mat, av_col = inputs[0], inputs[1]
    k, rp = ctx_mat.shape[1], ctx_mat.shape[-1] // 6
    n_rows = av_col.shape[0]
    isl = torch.arange(n_rows, device=av_col.device) // (n_rows // n_isl)
    route = isl * k + av_col[:, 0].long()
    base_len = (ctx_mat[..., :rp] < utils["n_stops"]).sum(-1).reshape(-1)
    need = torch.clamp(base_len + kd + 1, max=rp)
    sectors = int(((need[torch.unique(route)] * 4 + 31) // 32).sum())
    tables = 6 if utils["time_windowed"] else 3
    n_bytes = (tables * 32 * sectors + n_rows * 4
               + 4 * n_rows * 8 * 4 + 4 * n_rows * 8 * 4)
    n_ops = 40 * int(need[route].sum())
    bytes_ms = n_bytes / 3.35e12 * 1e3
    ops_ms = n_ops / 33.5e12 * 1e3
    if bytes_ms >= ops_ms:
        return n_bytes, n_ops, bytes_ms, "bytes"
    return n_bytes, n_ops, ops_ms, "operations"


def neighbourhood(req, islands, n, seed, full_route=False):
    """The port's own sampled neighbourhood around each island's base;
    `full_route` puts every stop of island 0 on vehicle 0."""
    import torch
    from greyjack_tpu_torch.ops import moves
    from greyjack_tpu_torch.solver.solver import island_generators

    vm = req.variables_manager
    cfg = moves.MoverConfig(vm, TABU_RATE, None, MOVE_PROBAS)
    gens = island_generators(seed, islands, req.device)
    base = torch.stack([vm.sample_variables(g, 1)[0] for g in gens])
    if full_route:
        ids = req.planning_schema["planning_stops"]["var_ids_np"]
        base[0, torch.as_tensor(ids["vehicle_id"]).long()] = 0
    ctx = req.build_base_ctx(base)
    deltas, _ = moves.move_population_delta(gens, base, n, vm, cfg,
                                            cfg.init_tabu_state(islands))
    return ctx, deltas


def compare(name, req, ctx, deltas):
    """Kernel vs plain version on the same inputs; returns max |diff|."""
    import torch
    from greyjack_tpu_torch.models.vrp import cotwin_builder as cb
    from greyjack_tpu_torch.models.vrp import delta_kernel as dk

    utils = req._delta_utils()
    inputs, aux = dk._pre(ctx, deltas, utils)
    tw = bool(utils["time_windowed"])
    rows_per_island = inputs[1].shape[0] // aux["n_islands"]
    route, warps, smem = dk._kernel_plan(
        rows_per_island, utils["k_vehicles"], inputs[0].shape[-1] // 6, tw)
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
    # the f64 route: score rows from the kernel's blocks, from the plain
    # blocks, and from the per-neighbour `score_delta` on the card
    rows_k = dk._post(got, aux, ctx, utils)
    rows_p = dk._post(want, aux, ctx, utils)
    rows_s = cb.score_delta(ctx, deltas, utils)
    if rows_k.dtype != torch.float64 or rows_k.shape != ints_k.shape:
        fail(f"{name}: f64 rows {rows_k.dtype}{tuple(rows_k.shape)}")
    if not torch.equal(rows_k, rows_p):
        fail(f"{name}: f64 rows of the kernel's blocks differ from the "
             "plain blocks'")
    if not torch.equal(rows_k, rows_s):
        e = float((rows_k - rows_s).abs().max().item())
        fail(f"{name}: f64 rows differ from score_delta's (max |diff| {e})")
    print(f"parity {name}: rows={inputs[1].shape[0]} on the {route} route "
          f"({warps} warps, {smem} B shared a block): blocks, i32 rows and "
          f"f64 rows bit-equal, f64 rows = score_delta (max_abs_err {err})",
          flush=True)
    return err, inputs, aux, route


def flagship_domain():
    from greyjack_tpu_torch.models.vrp import generate_instance
    return generate_instance(N_CUSTOMERS, N_DEPOTS, K_VEHICLES, seed=SEED,
                             time_windowed=True, device=DEVICE)


def flagship_agent(steps, sweep=False):
    from greyjack_tpu_torch.agents import TabuSearch
    from greyjack_tpu_torch.agents.termination_strategies import StepsLimit

    return TabuSearch(NEIGHBOURS, TABU_RATE, True, None, MOVE_PROBAS,
                      CHUNK_STEPS, StepsLimit(steps - 1), sweep=sweep,
                      sweep_targets=SWEEP_TARGETS, sweep_window=SWEEP_WINDOW)


def mh_agent(name, sweep, steps):
    """LateAcceptance ("LA") or SimulatedAnnealing ("SA") as
    `scripts/bench_mh.py` configures them, stopping after `steps` steps."""
    from greyjack_tpu_torch.agents import LateAcceptance, SimulatedAnnealing
    from greyjack_tpu_torch.agents.termination_strategies import StepsLimit

    kw = dict(sweep=sweep, sweep_targets=MH_TARGETS)
    if name == "LA":
        return LateAcceptance(LA_SIZE, TABU_RATE, None, MOVE_PROBAS,
                              CHUNK_STEPS, StepsLimit(steps - 1), **kw)
    return SimulatedAnnealing(SA_T0, SA_COOLING, TABU_RATE, None, MOVE_PROBAS,
                              CHUNK_STEPS, StepsLimit(steps - 1), **kw)


def solve_flagship(steps, metrics, sweep=False, agent=None,
                   n_islands=N_ISLANDS):
    from greyjack_tpu_torch.models.vrp import CotwinBuilder, DomainBuilder
    from greyjack_tpu_torch.solver import Solver, SolverLoggingLevels

    agent = agent or flagship_agent(steps, sweep)
    return Solver.solve(DomainBuilder.from_generator(flagship_domain),
                        CotwinBuilder(True, True), agent, n_islands, seed=0,
                        logging_level=SolverLoggingLevels.Silent,
                        metrics=metrics)


def check_solution(sol, path):
    """The returned score must be finite and equal a plain rescore of the
    returned solution, bit for bit. Returns (score, greedy start score)."""
    import torch
    from greyjack_tpu_torch.models.vrp import CotwinBuilder
    from greyjack_tpu_torch.score_calculation.score_requesters import (
        ScoreRequester)

    score = [sol[1]["hard_score"], sol[1]["medium_score"],
             sol[1]["soft_score"]]
    values = torch.tensor([[v for _, v in sol[0]]], dtype=torch.float32,
                          device=DEVICE)
    if values.shape[1] != 2 * N_CUSTOMERS:
        fail(f"{path} solution has {values.shape[1]} values")
    rescore_req = ScoreRequester(CotwinBuilder(True, False).build_cotwin(
        flagship_domain(), False))
    rescored = rescore_req.request_score_plain(values)[0].tolist()
    if not all(map(lambda x: x == x and abs(x) < 1e300, score)):
        fail(f"{path}: non-finite score {score}")
    if rescored != score:
        fail(f"{path}: solve score {score} != plain rescore {rescored}")
    start_score = rescore_req.request_score_plain(
        rescore_req.variables_manager.initial_values[None])[0].tolist()
    return score, start_score


def perturbed_bases(req, n_isl, seed, n_moves=40):
    """Greedy-init bases with a few seeded random moves (vehicle changes,
    customer swaps) applied, a different set per island."""
    import numpy as np
    import torch

    vm = req.variables_manager
    ids = req.planning_schema["planning_stops"]["var_ids_np"]
    upper = vm.upper_bounds.cpu().numpy()
    n_rows = len(ids["customer_id"])
    out = []
    for i in range(n_isl):
        rng = np.random.default_rng(seed + i)
        arr = vm.initial_values.cpu().numpy().copy()
        for _ in range(n_moves):
            a, b = rng.integers(n_rows), rng.integers(n_rows)
            arr[ids["vehicle_id"][a]] = rng.integers(
                int(upper[ids["vehicle_id"][a]]) + 1)
            ca, cb = ids["customer_id"][a], ids["customer_id"][b]
            arr[ca], arr[cb] = arr[cb], arr[ca]
        out.append(arr)
    return torch.from_numpy(np.stack(out))


def sweep_parity(n_isl=2, seed=11):
    """Phase 6: the sweep stages on the card vs on the CPU, same inputs,
    bit-equal (values, shapes and dtypes)."""
    import numpy as np
    import torch
    from greyjack_tpu_torch.models.vrp import CotwinBuilder, generate_instance
    from greyjack_tpu_torch.models.vrp import sweep
    from greyjack_tpu_torch.score_calculation.score_requesters import (
        ScoreRequester)

    outs = {}
    rng = np.random.default_rng(seed)
    inputs = None
    for dev in (DEVICE, "cpu"):
        dom = generate_instance(N_CUSTOMERS, N_DEPOTS, K_VEHICLES, seed=SEED,
                                time_windowed=True, device=dev)
        req = ScoreRequester(CotwinBuilder(True, True).build_cotwin(dom,
                                                                    False))
        if not req.supports_sweep:
            fail("the flagship is not sweep-eligible")
        utils = req._delta_utils()
        cfg = sweep.SweepConfig(req, SWEEP_TARGETS, SWEEP_WINDOW)
        if inputs is None:
            n, t = cfg.n_rows, cfg.targets
            inputs = (perturbed_bases(req, n_isl, seed),
                      torch.from_numpy(np.stack(
                          [rng.permutation(n)[:t] for _ in range(n_isl)]
                      ).astype(np.int32)),
                      torch.from_numpy(rng.random((n_isl, t)) < 0.9),
                      torch.from_numpy(rng.random((n_isl, n)) < 0.2))
        bases, t_rows, t_valid, row_tabu = (x.to(dev) for x in inputs)
        ctx = req.build_base_ctx(bases)
        tables = sweep.build_tables(ctx, cfg, utils)
        outs[dev] = {
            "tables": tables,
            "families": sweep.score_candidates(ctx, t_rows, t_valid,
                                               row_tabu, cfg, utils, tables),
            "propose": sweep.propose_from_targets(ctx, t_rows, t_valid,
                                                  row_tabu, cfg, utils),
        }
    torch.cuda.synchronize()

    def leaves(tree, prefix=""):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from leaves(v, f"{prefix}/{k}")
        elif isinstance(tree, (list, tuple)):
            for i, v in enumerate(tree):
                yield from leaves(v, f"{prefix}[{i}]")
        else:
            yield prefix, tree

    got = dict(leaves(outs[DEVICE]))
    want = dict(leaves(outs["cpu"]))
    if set(got) != set(want):
        fail(f"sweep parity: keys differ {set(got) ^ set(want)}")
    for name, w in want.items():
        g = got[name].cpu()
        if g.dtype != w.dtype or g.shape != w.shape or not torch.equal(g, w):
            fail(f"sweep parity: {name} differs on the card "
                 f"({g.dtype}{tuple(g.shape)} vs {w.dtype}{tuple(w.shape)})")
    fam = outs["cpu"]["families"]
    exact = outs["cpu"]["propose"][1]
    if not fam["c_valid"].any() or (exact[:, 0] == 2 ** 31 - 1).any():
        fail("sweep parity: inputs exercise no valid candidate")
    print(f"sweep parity: {n_isl} islands x {SWEEP_TARGETS} targets, window "
          f"{SWEEP_WINDOW}: {len(want)} arrays (tables, families, winner "
          f"delta / exact row / tabu info / stats) bit-equal, card vs CPU",
          flush=True)


def sweep_solve(card):
    """Phase 7: the flagship sweep solve through `Solver.solve`."""
    import torch
    from greyjack_tpu_torch.solver import SolverMetrics

    metrics = SolverMetrics()
    t0 = time.perf_counter()
    with CollectiveClock() as clock:
        sol = solve_flagship(SOLVE_STEPS, metrics, sweep=True)
        torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    recs = metrics.records
    paths = {r["kernel_path"] for r in recs}
    if paths != {"sweep"}:
        fail(f"the sweep solve ran path(s) {paths}, not sweep")
    steps_run = sum(r["steps"] for r in recs)
    if steps_run < SOLVE_STEPS or recs[-1]["n_alive"] != 0:
        fail(f"the sweep solve ran {steps_run} steps")
    scored = recs[-1]["sweep_scored"]
    nonconv = recs[-1]["sweep_nonconv"]
    if scored <= 0:
        fail("the sweep solve scored no candidate")
    score, start = check_solution(sol, "sweep")
    summ = metrics.summary()
    steady = recs[1:]
    steady_mps = (sum(r["moves"] for r in steady)
                  / (sum(r["wall_ms"] for r in steady) / 1e3)) if steady else 0
    per_step = recs[0]["moves"] // (N_ISLANDS * recs[0]["steps"])
    print(f"sweep solve: {steps_run} steps x {N_ISLANDS} islands x "
          f"{SWEEP_TARGETS} targets in {solve_s:.3f} s, path sweep; greedy "
          f"start {start} -> best {score} (= plain rescore)", flush=True)
    print(f"sweep solve rate [{card}]: {summ['moves_per_s']:.1f} conservative "
          f"scored moves/s over all chunks, {steady_mps:.1f} excluding the "
          f"first chunk ({per_step} moves counted per island-step); exact "
          f"counter {scored} scored candidates, {nonconv} non-converged "
          f"({100.0 * nonconv / scored:.3f}%); chunk ms "
          f"{[r['wall_ms'] for r in recs]}", flush=True)
    return sol, recs, clock.total_ms() / len(recs)


def mh_solve(card, name, sweep):
    """Phase 8: one LateAcceptance / SimulatedAnnealing flagship solve;
    returns the kernel's launch count in it."""
    import torch
    from greyjack_tpu_torch.models.vrp import delta_kernel as dk
    from greyjack_tpu_torch.solver import SolverMetrics

    label = f"{name}-{'sweep' if sweep else 'random'}"
    path = "sweep" if sweep else "delta"
    n_isl = N_ISLANDS if sweep else RANDOM_ISLANDS
    steps = SOLVE_STEPS if sweep else RANDOM_STEPS
    metrics = SolverMetrics()
    dk._call_kernel.launches = 0
    t0 = time.perf_counter()
    sol = solve_flagship(steps, metrics, agent=mh_agent(name, sweep, steps),
                         n_islands=n_isl)
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    launches = dk._call_kernel.launches
    recs = metrics.records
    paths = {r["kernel_path"] for r in recs}
    if paths != {path}:
        fail(f"{label}: the solve ran path(s) {paths}, not {path}")
    steps_run = sum(r["steps"] for r in recs)
    if steps_run < steps or recs[-1]["n_alive"] != 0:
        fail(f"{label}: the solve ran {steps_run} steps")
    if sweep and recs[-1]["sweep_scored"] <= 0:
        fail(f"{label}: the sweep solve scored no candidate")
    if not sweep and launches <= 0:
        fail(f"{label}: the solve never launched the CUDA delta kernel")
    score, start = check_solution(sol, label)
    summ = metrics.summary()
    steady = recs[1:]
    steady_mps = (sum(r["moves"] for r in steady)
                  / (sum(r["wall_ms"] for r in steady) / 1e3)) if steady else 0
    extra = (f"exact counter {recs[-1]['sweep_scored']} scored candidates, "
             f"{recs[-1]['sweep_nonconv']} non-converged" if sweep
             else f"kernel launches {launches}")
    print(f"{label} solve: {steps_run} steps x {n_isl} islands in "
          f"{solve_s:.3f} s, path {path}, {extra}; greedy start {start} -> "
          f"best {score} (= plain rescore)", flush=True)
    print(f"{label} solve rate [{card}]: {summ['moves_per_s']:.1f} scored "
          f"moves/s over all chunks, {steady_mps:.1f} excluding the first "
          f"chunk ({recs[0]['moves'] // (n_isl * recs[0]['steps'])} counted "
          f"per island-step); chunk ms {[r['wall_ms'] for r in recs]}",
          flush=True)
    return launches


def move_parity(n_isl=8, n=256, seed=13):
    """Phase 9: the generic move library's deterministic bodies on the
    card vs on the CPU, fed the same noise: the port's draws, made once on
    the CPU from a seed and copied to the card. `do_move` / `do_move_delta`
    / `apply_delta` outputs and tabu info must be bit-equal (values,
    shapes and dtypes) under every single move type and the default
    six-equal mix, at mutation multipliers None and 1.0, with tabu on."""
    import torch
    from greyjack_tpu_torch.models.vrp import CotwinBuilder, generate_instance
    from greyjack_tpu_torch.ops import moves, selection
    from greyjack_tpu_torch.score_calculation.score_requesters import (
        ScoreRequester)
    from greyjack_tpu_torch.solver.solver import island_generators

    reqs = {dev: ScoreRequester(CotwinBuilder(True, True).build_cotwin(
        generate_instance(N_CUSTOMERS, N_DEPOTS, K_VEHICLES, seed=SEED,
                          time_windowed=True, device=dev), False))
        for dev in (DEVICE, "cpu")}
    vm_c = reqs["cpu"].variables_manager
    base = perturbed_bases(reqs["cpu"], n_isl, seed)
    gens = island_generators(seed, n_isl, "cpu")
    pop = base[:, None].repeat(1, n, 1)
    pop[:, 1::2] = torch.stack([vm_c.sample_variables(g, n // 2)
                                for g in gens])

    def to(tree, dev):
        if isinstance(tree, dict):
            return {k: to(v, dev) for k, v in tree.items()}
        return tree.to(dev)

    def same(name, w, g):
        g = g.cpu()
        if g.dtype != w.dtype or g.shape != w.shape or not torch.equal(g, w):
            fail(f"move parity: {name} differs on the card "
                 f"({g.dtype}{tuple(g.shape)} vs {w.dtype}{tuple(w.shape)})")

    singles = [[1.0 if i == j else 0.0 for i in range(6)] for j in range(6)]
    n_cases, n_wide = 0, 0
    for probas in singles + [None]:
        for mult in (None, 1.0):
            label = f"probas={probas} mult={mult}"
            cfg_c = moves.MoverConfig(vm_c, TABU_RATE, mult, probas)
            tabu = cfg_c.init_tabu_state(n_isl)
            for _ in range(6):
                grp = torch.randint(0, max(1, cfg_c.n_groups), (n_isl,),
                                    generator=gens[0])
                pos = torch.randint(0, cfg_c.max_group_size, (n_isl, 4),
                                    generator=gens[0], dtype=torch.int32)
                tabu = selection.tabu_push(
                    tabu, grp, pos, torch.full((n_isl,), 4, dtype=torch.int32))
            noise_m = moves.draw_move_noise(gens, n, vm_c, cfg_c,
                                            torch.float32)
            noise_d = moves.draw_delta_noise(gens, n, vm_c, cfg_c,
                                             torch.float32)
            out = {}
            for dev, req in reqs.items():
                vm = req.variables_manager
                cfg = moves.MoverConfig(vm, TABU_RATE, mult, probas)
                masks = cfg.tabu_masks(to(tabu, dev))
                moved, info = moves.do_move(pop.to(dev), to(noise_m, dev), vm,
                                            cfg, masks)
                delta, dinfo = moves.do_move_delta(base.to(dev),
                                                   to(noise_d, dev), vm, cfg,
                                                   masks)
                winner = {k: v[:, 0] for k, v in delta.items()}
                out[dev] = {"moved": moved, "info": info, "delta": delta,
                            "delta_info": dinfo,
                            "applied": moves.apply_delta(base.to(dev),
                                                         winner)}
            torch.cuda.synchronize()
            for part in ("moved", "applied"):
                same(f"{label} {part}", out["cpu"][part], out[DEVICE][part])
            for part in ("info", "delta", "delta_info"):
                for k, w in out["cpu"][part].items():
                    same(f"{label} {part}/{k}", w, out[DEVICE][part][k])
            if not (out["cpu"]["moved"] != pop).any() \
                    or not out["cpu"]["delta"]["valid"].any():
                fail(f"move parity: {label} moved nothing")
            n_cases += 1
            n_wide += cfg_c.delta_width > 8
    print(f"move parity: {n_cases} configurations x {n_isl} islands x {n} "
          f"candidates (tabu {TABU_RATE}): do_move candidates + info, "
          f"do_move_delta deltas + info, apply_delta ({n_wide} wide, "
          f"{n_cases - n_wide} narrow) bit-equal, card vs CPU", flush=True)


def sampler_bound(u, columns, pop, vm, cfg, masks):
    """(bytes read, bytes written, bound_ms) of one sampler-kernel call on
    these inputs, over the H100's 3.35 TB/s: of u, the columns each
    candidate reads (four scalars, the Gumbel columns of its group's valid
    positions, the Binomial columns where the rate is not 0, at most
    SCRAMBLE_MAX permutation keys for a scramble and MAX_MOVE_SIZE values
    for a change), its row of the candidates (a stride-0 base once an
    island), its island's tabu masks and the fix's tables once; the rows
    and the info written once."""
    import torch
    from greyjack_tpu_torch import config
    from greyjack_tpu_torch.ops import move_kernel

    n_isl, p, v = pop.shape
    lmax = cfg.max_group_size
    dims = move_kernel.noise_dims(columns, v, lmax)
    mt = (cfg.thresholds < u[..., dims["off_move"], None]).sum(-1)
    n_g = dims["g_hi"] - dims["g_lo"]
    g = torch.clamp(torch.floor(u[..., dims["off_g"]] * n_g), max=n_g - 1)
    limit = (cfg.group_sizes[g.long()].long() - (mt == 2).long()).clamp(min=0)
    cols = (4 + limit + (mt == 0).long() * config.MAX_MOVE_SIZE
            + (mt == 3).long() * config.SCRAMBLE_MAX)
    if dims["off_count"] >= 0:
        cols = cols + v
    elt = pop.element_size()
    n_groups = vm.group_members.shape[0]
    rows = n_isl if pop.stride(1) == 0 else n_isl * p
    n_read = (8 * int(cols.sum()) + rows * v * elt
              + (0 if masks is None else masks.numel())
              + v * (3 * elt + 2) + n_groups * (4 * lmax + 12) + 48)
    n_written = n_isl * p * (v * elt + 4 * (config.MAX_MOVE_SIZE + 2))
    return n_read, n_written, (n_read + n_written) / 3.35e12 * 1e3


def sampler_phase(card, seed=19):
    """Phase 9, second half: the plain sampler kernel against the torch
    body on the card, fed the same uniforms, at TS-plain's shape (8
    islands x 2048 candidates, six equal moves, tabu 0.2, the rings filled
    by six rounds of pushes): on the island's base expanded with stride 0
    over the candidates, as TabuSearch passes it, and on a real population
    off the grid and out of bounds. The rows (bit for bit) and the tabu
    info must equal `fix_all(do_move(...))`'s. Then the kernel's times on
    the stride-0 base beside its bound; returns them for the kernel
    table."""
    import torch
    from greyjack_tpu_torch.models.vrp import CotwinBuilder
    from greyjack_tpu_torch.ops import move_kernel, moves
    from greyjack_tpu_torch.score_calculation.score_requesters import (
        ScoreRequester)
    from greyjack_tpu_torch.solver.solver import island_generators

    req = ScoreRequester(CotwinBuilder(False, True).build_cotwin(
        flagship_domain(), False))
    vm = req.variables_manager
    cfg = moves.MoverConfig(vm, TABU_RATE, None, None)
    n_isl, p, v = N_ISLANDS, PLAIN_NEIGHBOURS, vm.variables_count
    gens = island_generators(seed, n_isl, DEVICE)
    base = perturbed_bases(req, n_isl, seed).to(DEVICE, vm.float_dtype)
    tabu = cfg.init_tabu_state(n_isl)
    for r in range(6):
        _, info = moves.do_move(
            base[:, None].expand(n_isl, 64, v),
            moves.draw_move_noise(gens, 64, vm, cfg, base.dtype), vm, cfg,
            cfg.tabu_masks(tabu))
        tabu = moves.update_tabu_from_info(
            tabu, info, torch.full((n_isl,), r, device=DEVICE))
    masks = cfg.tabu_masks(tabu)
    real = torch.stack([vm.sample_variables(g, p) for g in gens])
    real = real + 3.0 * torch.rand(real.shape, generator=gens[0],
                                   dtype=real.dtype, device=DEVICE) - 1.5
    stride0 = base[:, None].expand(n_isl, p, v)
    fields = moves.move_noise_fields(vm, cfg)
    columns = moves.field_columns(fields)

    def body(u, pop):
        moved, info = moves.do_move(
            pop, moves.noise_leaves(u, fields, cfg, pop.dtype), vm, cfg,
            masks)
        return vm.fix_all(moved), info

    launches = move_kernel.move_and_fix.launches
    for label, pop in (("stride-0 base", stride0), ("real population", real)):
        u = moves.draw_uniforms(gens, p, fields, DEVICE)
        got, got_info = move_kernel.move_and_fix(u, columns, pop, vm, cfg,
                                                 masks)
        want, info = body(u, pop)
        torch.cuda.synchronize()
        if (got.dtype != want.dtype or got.shape != want.shape
                or not torch.equal(got.view(torch.uint8),
                                   want.view(torch.uint8))):
            fail(f"sampler kernel: {label} rows differ from the torch body")
        for k in ("group", "positions", "count"):
            if not torch.equal(got_info[k], info[k].to(torch.int32)):
                fail(f"sampler kernel: {label} info {k} differs from the "
                     "torch body")
        moved_rows = int((got != vm.fix_all(pop.contiguous())).any(-1).sum())
        if moved_rows == 0:
            fail(f"sampler kernel: {label} moved nothing")
        print(f"sampler kernel parity, {label}: {n_isl} x {p} candidates x "
              f"{v} variables ({got.dtype}, six equal moves, tabu "
              f"{TABU_RATE}): rows and info bit-equal to the torch body on "
              f"the card; {moved_rows} rows moved", flush=True)
    if move_kernel.move_and_fix.launches != launches + 2:
        fail("sampler kernel: move_and_fix did not count its launches")

    u = moves.draw_uniforms(gens, p, fields, DEVICE)
    dev_ms, dev_all = graph_ms(lambda: move_kernel.move_and_fix(
        u, columns, stride0, vm, cfg, masks))
    w_ms, w_all = cuda_ms(lambda: move_kernel.move_and_fix(
        u, columns, stride0, vm, cfg, masks))
    p_ms, p_all = cuda_ms(lambda: body(u, stride0), inner=3)
    d_ms, _ = cuda_ms(lambda: moves.draw_uniforms(gens, p, fields, DEVICE))
    n_read, n_written, b_ms = sampler_bound(u, columns, stride0, vm, cfg,
                                            masks)
    print(f"sampler kernel time [{card}] at {n_isl} x {p} candidates: device "
          f"only (CUDA graph of move_and_fix) {dev_ms:.5f} ms (runs "
          f"{[round(t, 5) for t in dev_all]}); with the wrapper (event-timed)"
          f" {w_ms:.4f} ms (runs {[round(t, 4) for t in w_all]}); torch body "
          f"{p_ms:.4f} ms (runs {[round(t, 4) for t in p_all]}); the draw "
          f"{d_ms:.4f} ms; bound {b_ms:.5f} ms by bytes ({n_read} B read, "
          f"{n_written} B written), {100 * b_ms / dev_ms:.1f}% of it",
          flush=True)
    return {"rows": n_isl * p, "dtype": str(stride0.dtype),
            "device_ms": dev_ms, "wrapper_ms": w_ms, "plain_ms": p_ms,
            "draw_ms": d_ms, "bound_ms": b_ms, "bound_by": "bytes",
            "bytes_read": n_read, "bytes_written": n_written}

def plain_bound(rows, n, k):
    """(bytes read, bytes written, bound_ms) of one route-analysis kernel
    call over `rows` rows of `n` stops and `k` vehicles, over the H100's
    3.35 TB/s: the two i32 id columns read once, the distance, penalty,
    duplicate count and loads written once. The tables (the milli matrix,
    4 MB at the flagship, and the customer rows) stay in L2 and are left
    out; so is every lookup into them."""
    n_read = 2 * rows * n * 4
    n_written = rows * (8 + 8 + 4 + 4 * k)
    return n_read, n_written, (n_read + n_written) / 3.35e12 * 1e3


def plain_score_phase(card, seed=29):
    """Phase 10, first part: the plain score's route-analysis kernel
    (`csrc/vrp_plain.cu`) against the torch body of `build_common`, on the
    same card tensors, at the plain cell's shape (16,384 rows of the
    flagship: 1000 stops, 40 vehicles, 1008 locations): TS-plain's
    candidates (8 islands x 2048 one-move neighbours of perturbed greedy
    bases, fixed) and random rows of the cotwin without a greedy start.
    `build_common`'s four outputs and `request_score_plain`'s rows must be
    bit-equal with the kernel and with the torch body forced. Then the
    kernel's times on the candidates beside its byte bound; returns them
    for the kernel table."""
    import torch
    from greyjack_tpu_torch.models.vrp import CotwinBuilder, cotwin_builder
    from greyjack_tpu_torch.ops import moves, plain_kernel
    from greyjack_tpu_torch.score_calculation.score_requesters import (
        ScoreRequester)
    from greyjack_tpu_torch.solver.solver import island_generators

    n_isl, p = N_ISLANDS, PLAIN_NEIGHBOURS
    real_eligible = plain_kernel.eligible

    def torch_body(fn):
        plain_kernel.eligible = lambda v, utils: False
        try:
            return fn()
        finally:
            plain_kernel.eligible = real_eligible

    req = ScoreRequester(CotwinBuilder(False, True).build_cotwin(
        flagship_domain(), False))
    vm = req.variables_manager
    cfg = moves.MoverConfig(vm, TABU_RATE, None, None)
    gens = island_generators(seed, n_isl, DEVICE)
    base = perturbed_bases(req, n_isl, seed).to(DEVICE, vm.float_dtype)
    moved, _ = moves.do_move(
        base[:, None].expand(n_isl, p, vm.variables_count),
        moves.draw_move_noise(gens, p, vm, cfg, base.dtype), vm, cfg, None)
    candidates = vm.fix_all(moved).reshape(n_isl * p, -1)
    rand_req = ScoreRequester(CotwinBuilder(False, False).build_cotwin(
        flagship_domain(), False))
    random_rows = rand_req.variables_manager.sample_variables(gens[0],
                                                              n_isl * p)
    timed = None
    for label, r, pop in (("TS-plain candidates", req, candidates),
                          ("random rows", rand_req, random_rows)):
        utils = dict(r.cotwin.score_calculator.utility_objects)
        frames = r.build_frames(pop)
        cols = frames["planning_stops"]
        v = cols["vehicle_id"].contiguous()
        c = cols["customer_id"].contiguous()
        if not plain_kernel.eligible(v, utils):
            fail(f"plain kernel: {label} are not eligible")
        launches = plain_kernel.route_analysis.launches
        got = cotwin_builder.build_common(frames, None, utils)
        if plain_kernel.route_analysis.launches != launches + 1:
            fail(f"plain kernel: build_common did not launch it on {label}")
        want = torch_body(
            lambda: cotwin_builder.build_common(frames, None, utils))
        for key, w in want.items():
            g = got[key]
            if g.dtype != w.dtype or g.shape != w.shape or not torch.equal(
                    g.view(torch.uint8), w.view(torch.uint8)):
                fail(f"plain kernel: {label} {key} differs from the torch "
                     "body")
        rows_k = r.request_score_plain(pop)
        rows_t = torch_body(lambda: r.request_score_plain(pop))
        if not torch.equal(rows_k.view(torch.uint8), rows_t.view(torch.uint8)):
            fail(f"plain kernel: {label} score rows differ from the torch "
                 "body's")
        late = int((got["route_lateness"] > 0).sum())
        print(f"plain kernel parity, {label}: {v.shape[0]} rows x "
              f"{v.shape[1]} stops, {utils['k_vehicles']} vehicles, "
              f"{utils['n_locations']} locations: build_common's four "
              f"outputs and the score rows bit-equal to the torch body on "
              f"the card; {late} rows late", flush=True)
        if timed is None:
            timed = (r, pop, frames, v, c, utils)

    r, pop, frames, v, c, utils = timed
    rows, n = v.shape
    k = utils["k_vehicles"]
    dev_ms, dev_all = graph_ms(
        lambda: plain_kernel.route_analysis(v, c, utils))
    w_ms, w_all = cuda_ms(lambda: plain_kernel.route_analysis(v, c, utils))
    p_ms, p_all = torch_body(lambda: cuda_ms(
        lambda: cotwin_builder.build_common(frames, None, utils), inner=3))
    bc_ms, _ = cuda_ms(lambda: cotwin_builder.build_common(frames, None,
                                                           utils))
    sk_ms, _ = cuda_ms(lambda: r.request_score_plain(pop), inner=3)
    st_ms, _ = torch_body(lambda: cuda_ms(
        lambda: r.request_score_plain(pop), inner=3))
    n_read, n_written, b_ms = plain_bound(rows, n, k)
    print(f"plain kernel time [{card}] at {rows} rows x {n} stops: device "
          f"only (CUDA graph of route_analysis) {dev_ms:.5f} ms (runs "
          f"{[round(t, 5) for t in dev_all]}); with the wrapper (event-timed)"
          f" {w_ms:.4f} ms (runs {[round(t, 4) for t in w_all]}); torch body "
          f"of build_common {p_ms:.4f} ms (runs {[round(t, 4) for t in p_all]}"
          f"), build_common with the kernel {bc_ms:.4f} ms; "
          f"request_score_plain {sk_ms:.4f} ms, with the torch body "
          f"{st_ms:.4f} ms; bound {b_ms:.5f} ms by bytes ({n_read} B read, "
          f"{n_written} B written), {100 * b_ms / dev_ms:.1f}% of it",
          flush=True)
    return {"rows": rows, "stops": n, "vehicles": k, "device_ms": dev_ms,
            "wrapper_ms": w_ms, "plain_ms": p_ms, "build_common_ms": bc_ms,
            "score_ms": sk_ms, "score_plain_ms": st_ms, "bound_ms": b_ms,
            "bound_by": "bytes", "bytes_read": n_read,
            "bytes_written": n_written}


def plain_agent(label, steps):
    """The agents of phase 10, stopping after `steps` steps: GA / GA-wide
    (`scripts/bench_mh.py:112-121`), TabuSearch with the six equal moves
    (`:91`'s 2048 neighbours), LA / SA as their random-move forms
    (`:105-111`)."""
    from greyjack_tpu_torch.agents import (GeneticAlgorithm, LateAcceptance,
                                           SimulatedAnnealing, TabuSearch)
    from greyjack_tpu_torch.agents.termination_strategies import StepsLimit

    lim = StepsLimit(steps - 1)
    if label.startswith("GA"):
        return GeneticAlgorithm(GA_POP, 0.5, 0.05, TABU_RATE, None,
                                MOVE_PROBAS, 0.1, CHUNK_STEPS, lim)
    if label.startswith("TS"):
        return TabuSearch(PLAIN_NEIGHBOURS, TABU_RATE, True, None, None,
                          CHUNK_STEPS, lim)
    if label == "LA-plain":
        return LateAcceptance(LA_SIZE, TABU_RATE, None, MOVE_PROBAS,
                              CHUNK_STEPS, lim)
    return SimulatedAnnealing(SA_T0, SA_COOLING, TABU_RATE, None, MOVE_PROBAS,
                              CHUNK_STEPS, lim)


# phase 10: (label, islands, steps, delta cotwin, path)
PLAIN_SOLVES = [("GA", 8, 200, True, "plain"),
                ("GA-wide", 64, 50, True, "plain"),
                ("TS-plain", 8, 50, False, "plain"),
                ("LA-plain", RANDOM_ISLANDS, 100, False, "plain"),
                ("SA-plain", RANDOM_ISLANDS, 100, False, "plain"),
                ("TS-six-move", 8, 50, True, "int-delta")]


def plain_solve(card, label, n_isl, steps, delta_cotwin, path):
    """Phase 10: one solve of the plain path (or of the six-move delta
    path) through `Solver.solve` at the flagship's full width: every chunk
    must report `path`, the returned score must equal a plain rescore, bit
    for bit, and the six-move delta solve must not launch the delta kernel
    (kd 16 scores through the f64 `score_delta`; its label is the JAX
    package's, which names the registered int rows). The solves of
    KERNEL_PLAIN must launch the sampler kernel, the others must not. The
    plain score's kernel must launch once for the initial scores and, on
    the plain path, once a step; returns the launches of both kernels."""
    import torch
    from greyjack_tpu_torch.models.vrp import CotwinBuilder, DomainBuilder
    from greyjack_tpu_torch.models.vrp import delta_kernel as dk
    from greyjack_tpu_torch.ops import move_kernel, plain_kernel
    from greyjack_tpu_torch.solver import (Solver, SolverLoggingLevels,
                                           SolverMetrics)

    metrics = SolverMetrics()
    dk._call_kernel.launches = 0
    move_kernel.move_and_fix.launches = 0
    plain_kernel.route_analysis.launches = 0
    t0 = time.perf_counter()
    sol = Solver.solve(DomainBuilder.from_generator(flagship_domain),
                       CotwinBuilder(delta_cotwin, True),
                       plain_agent(label, steps), n_isl, seed=0,
                       logging_level=SolverLoggingLevels.Silent,
                       metrics=metrics)
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    launches = dk._call_kernel.launches
    recs = metrics.records
    paths = {r["kernel_path"] for r in recs}
    if paths != {path}:
        fail(f"{label}: the solve ran path(s) {paths}, not {path}")
    steps_run = sum(r["steps"] for r in recs)
    if steps_run < steps or recs[-1]["n_alive"] != 0:
        fail(f"{label}: the solve ran {steps_run} steps")
    if launches != 0:
        fail(f"{label}: the solve launched the delta kernel {launches} times")
    sampled = move_kernel.move_and_fix.launches
    if (sampled > 0) != (label in KERNEL_PLAIN):
        fail(f"{label}: the solve launched the sampler kernel {sampled} "
             "times")
    scored = plain_kernel.route_analysis.launches
    if scored != (steps_run + 1 if path == "plain" else 1):
        fail(f"{label}: the solve launched the plain score's kernel {scored} "
             f"times in {steps_run} steps")
    score, start = check_solution(sol, label)
    summ = metrics.summary()
    steady = recs[1:]
    steady_mps = (sum(r["moves"] for r in steady)
                  / (sum(r["wall_ms"] for r in steady) / 1e3)) if steady else 0
    per_step = recs[0]["moves"] // (n_isl * recs[0]["steps"])
    print(f"{label} solve: {steps_run} steps x {n_isl} islands x {per_step} "
          f"moves in {solve_s:.3f} s, path {path}, delta kernel launches "
          f"{launches}, sampler kernel launches {sampled}, plain score "
          f"kernel launches {scored}; greedy start {start} -> best {score} "
          f"(= plain rescore)", flush=True)
    print(f"{label} solve rate [{card}]: {summ['moves_per_s']:.1f} scored "
          f"moves/s over all chunks, {steady_mps:.1f} excluding the first "
          f"chunk; chunk ms {[r['wall_ms'] for r in recs]}", flush=True)
    return sampled, scored


def to_device(tree, dev):
    if isinstance(tree, dict):
        return {k: to_device(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def rate_line(label, card, recs, n_isl):
    """The solve's scored moves/s over all chunks and without chunk 0, its
    ms a step, beside the card's name and power limit."""
    def mps(rs):
        wall = sum(r["wall_ms"] for r in rs) / 1e3
        return sum(r["moves"] for r in rs) / wall if wall > 0 else 0.0

    steps = sum(r["steps"] for r in recs[1:])
    step_ms = (sum(r["wall_ms"] for r in recs[1:]) / steps) if steps else 0
    print(f"{label} solve rate [{card}]: {mps(recs):.1f} scored moves/s "
          f"over all chunks, {mps(recs[1:]):.1f} excluding the first chunk "
          f"({recs[0]['moves'] // (n_isl * recs[0]['steps'])} counted per "
          f"island-step, {step_ms:.3f} ms a step without chunk 0); chunk ms "
          f"{[r['wall_ms'] for r in recs]}", flush=True)


class RunnerWatch:
    """Records, after every chunk of every `IslandRunner` while active, the
    largest value of the island leaf `key` (e.g. LSHADE's `arc_count`).

    The patched `run_chunk` only keeps a reference to the state it returns;
    the reduction and its device-to-host read happen in `update_metrics`,
    which `Solver.solve` calls as an observer after it has timed the
    chunk, so the solve's `wall_ms` carries no work of this watch."""

    def __init__(self, key):
        from greyjack_tpu_torch.parallel import IslandRunner
        self.cls, self.key, self.seen = IslandRunner, key, []
        self.orig = IslandRunner.run_chunk
        self.last = None

    def __enter__(self):
        watch = self

        def run_chunk(runner, *a, **k):
            watch.last = watch.orig(runner, *a, **k)
            return watch.last

        self.cls.run_chunk = run_chunk
        return self

    def __exit__(self, *exc):
        self.cls.run_chunk = self.orig

    def update(self, solution):
        pass

    def update_metrics(self, record):
        self.seen.append(int(self.last["islands"][self.key].max()))


def lshade_agent(steps, mixed=False):
    """LSHADE as `scripts/bench_mh.py` configures it on the flagship
    (`:114-115`) or on the mixed-int model (`:137-138`: change moves only,
    tabu rate 0), stopping after `steps` steps."""
    from greyjack_tpu_torch.agents import LSHADE
    from greyjack_tpu_torch.agents.termination_strategies import StepsLimit

    tabu, probas = ((0.0, [1.0, 0.0, 0.0, 0.0, 0.0, 0.0]) if mixed
                    else (TABU_RATE, MOVE_PROBAS))
    return LSHADE(LSHADE_POP, LSHADE_POP, 0.2, 0.1, 1, 0.5, 0.9, 0.5, tabu,
                  None, probas, 0.1, CHUNK_STEPS, StepsLimit(steps - 1))


def lshade_body_parity(n_isl=N_ISLANDS, seed=17):
    """Phase 11a: one LSHADE body step on the card vs on the CPU, from the
    same state (the CPU's after one step, so the archive holds rows) and
    the same leaves (drawn once on the CPU)."""
    import numpy as np
    import torch
    from greyjack_tpu_torch.models.vrp import CotwinBuilder, generate_instance
    from greyjack_tpu_torch.score_calculation.score_requesters import (
        ScoreRequester)
    from greyjack_tpu_torch.solver.solver import island_generators

    kernels = {dev: lshade_agent(10 ** 9).build_kernel(ScoreRequester(
        CotwinBuilder(True, True).build_cotwin(generate_instance(
            N_CUSTOMERS, N_DEPOTS, K_VEHICLES, seed=SEED, time_windowed=True,
            device=dev), False))) for dev in (DEVICE, "cpu")}
    gens = island_generators(seed, n_isl, "cpu")
    state = kernels["cpu"].step(gens, kernels["cpu"].init_state(gens), {})
    leaves = kernels["cpu"].draw(gens)
    out = {dev: kernels[dev].body(to_device(state, dev),
                                  to_device(leaves, dev))
           for dev in (DEVICE, "cpu")}
    torch.cuda.synchronize()
    if int(state["arc_count"].min()) <= 0:
        fail("lshade parity: the input archive is empty")
    worst = {}

    def check(name, w, g):
        if isinstance(w, dict):
            for k in w:
                check(f"{name}/{k}", w[k], g[k])
            return
        g = g.cpu()
        if g.dtype != w.dtype or g.shape != w.shape:
            fail(f"lshade parity: {name} is {g.dtype}{tuple(g.shape)} on the "
                 f"card, {w.dtype}{tuple(w.shape)} on the CPU")
        if name.startswith("adaptive_"):
            rel = float(((g - w).abs() / w.abs().clamp(min=1e-300)).max())
            worst[name] = rel
            if rel > 1e-12:
                fail(f"lshade parity: {name} differs by a relative {rel}")
        elif name == "arc_f":
            ulps = float(((g - w).abs() / torch.from_numpy(
                np.spacing(w.abs().numpy()))).max())
            worst[name] = ulps
            if ulps > 4:
                fail(f"lshade parity: arc_f differs by {ulps} ulp")
        elif not torch.equal(g, w):
            fail(f"lshade parity: {name} differs on the card")

    for key, w in out["cpu"].items():
        check(key, w, out[DEVICE][key])
    print(f"lshade parity: {n_isl} islands x {LSHADE_POP}, one body step "
          f"from an archive of {state['arc_count'].tolist()} rows: "
          f"{len(out['cpu'])} leaves, integer leaves / population / scores "
          f"/ archive / arc_cr bit-equal card vs CPU; arc_f max "
          f"{worst['arc_f']:.1f} ulp; adaptive memories max relative "
          f"{max(v for k, v in worst.items() if k != 'arc_f'):.3e}",
          flush=True)


def lshade_solve(card, label, n_isl, steps):
    """Phase 11b: an LSHADE flagship solve through `Solver.solve`; it must
    launch neither the delta nor the sampler kernel, and the plain score's
    kernel once for the initial scores and once a step; returns those
    launches."""
    import torch
    from greyjack_tpu_torch.models.vrp import CotwinBuilder, DomainBuilder
    from greyjack_tpu_torch.models.vrp import delta_kernel as dk
    from greyjack_tpu_torch.ops import move_kernel, plain_kernel
    from greyjack_tpu_torch.solver import (Solver, SolverLoggingLevels,
                                           SolverMetrics)

    metrics = SolverMetrics()
    dk._call_kernel.launches = 0
    move_kernel.move_and_fix.launches = 0
    plain_kernel.route_analysis.launches = 0
    t0 = time.perf_counter()
    with RunnerWatch("arc_count") as watch:
        sol = Solver.solve(DomainBuilder.from_generator(flagship_domain),
                           CotwinBuilder(True, True), lshade_agent(steps),
                           n_isl, seed=0,
                           logging_level=SolverLoggingLevels.Silent,
                           metrics=metrics, observers=[watch])
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    launches = dk._call_kernel.launches
    recs = metrics.records
    paths = {r["kernel_path"] for r in recs}
    if paths != {"plain"}:
        fail(f"{label}: the solve ran path(s) {paths}, not plain")
    steps_run = sum(r["steps"] for r in recs)
    if steps_run < steps or recs[-1]["n_alive"] != 0:
        fail(f"{label}: the solve ran {steps_run} steps")
    if launches != 0:
        fail(f"{label}: the solve launched the delta kernel {launches} times")
    if move_kernel.move_and_fix.launches != 0:
        fail(f"{label}: the solve launched the sampler kernel")
    scored = plain_kernel.route_analysis.launches
    if scored != steps_run + 1:
        fail(f"{label}: the solve launched the plain score's kernel {scored} "
             f"times in {steps_run} steps")
    if len(watch.seen) != len(recs) or max(watch.seen) > LSHADE_POP:
        fail(f"{label}: archive counts {watch.seen} (h = {LSHADE_POP})")
    score, start = check_solution(sol, label)
    print(f"{label} solve: {steps_run} steps x {n_isl} islands x "
          f"{LSHADE_POP} moves in {solve_s:.3f} s, path plain, delta kernel "
          f"launches 0, plain score kernel launches {scored}, largest "
          f"archive count per chunk {watch.seen}; greedy start {start} -> "
          f"best {score} (= plain rescore)", flush=True)
    rate_line(label, card, recs, n_isl)
    return scored


def mixed_builders():
    from greyjack_tpu_torch.models.mixedint import (CotwinBuilder,
                                                    DomainBuilder)
    return (DomainBuilder(MIXED_FLOATS, MIXED_INTS, objective="rastrigin",
                          device=DEVICE), CotwinBuilder())


def mixed_agent(label, steps):
    """Phase 12's agents (`scripts/bench_mh.py:127-142`): change moves only,
    tabu rate 0, population / neighbourhood 128."""
    from greyjack_tpu_torch.agents import GeneticAlgorithm, TabuSearch
    from greyjack_tpu_torch.agents.termination_strategies import StepsLimit

    probas = [1.0, 0.0, 0.0, 0.0, 0.0, 0.0]
    lim = StepsLimit(steps - 1)
    if label.startswith("mixedint-GA"):
        return GeneticAlgorithm(GA_POP, 0.5, 0.05, 0.0, None, probas, 0.1,
                                CHUNK_STEPS, lim)
    if label.startswith("mixedint-LSHADE"):
        return lshade_agent(steps, mixed=True)
    return TabuSearch(GA_POP, 0.0, True, None, probas, CHUNK_STEPS, lim)


def mixed_solve(card, label, n_isl=N_ISLANDS, steps=SOLVE_STEPS):
    """Phase 12: one mixed-int rastrigin solve (50 floats + 50 ints)."""
    import torch
    from greyjack_tpu_torch.parallel import IslandRunner
    from greyjack_tpu_torch.score_calculation.score_requesters import (
        ScoreRequester)
    from greyjack_tpu_torch.solver import (Solver, SolverLoggingLevels,
                                           SolverMetrics)
    from greyjack_tpu_torch.solver.solver import island_generators

    db, cb = mixed_builders()
    req = ScoreRequester(cb.build_cotwin(db.build_domain_from_scratch(),
                                         False))
    # the start: the best of the initial populations the solve draws
    start = float(IslandRunner(
        mixed_agent(label, steps).build_kernel(req), n_isl, CHUNK_STEPS
    ).init(island_generators(0, n_isl, DEVICE))["islands"]["scores"].min())
    metrics = SolverMetrics()
    t0 = time.perf_counter()
    sol = Solver.solve(db, cb, mixed_agent(label, steps), n_isl, seed=0,
                       logging_level=SolverLoggingLevels.Silent,
                       metrics=metrics)
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    recs = metrics.records
    paths = {r["kernel_path"] for r in recs}
    if paths != {"plain"}:
        fail(f"{label}: the solve ran path(s) {paths}, not plain")
    steps_run = sum(r["steps"] for r in recs)
    if steps_run < steps or recs[-1]["n_alive"] != 0:
        fail(f"{label}: the solve ran {steps_run} steps")
    values = [v for _, v in sol[0]]
    if len(values) != MIXED_FLOATS + MIXED_INTS or not all(
            float(v) == int(v) for v in values[MIXED_FLOATS:]):
        fail(f"{label}: the solution's integer slots are not integral")
    score = sol[1]["simple_value"]
    rescored = float(req.request_score_plain(torch.tensor(
        [values], dtype=torch.float32, device=DEVICE))[0, 0])
    if not abs(score) < 1e300:
        fail(f"{label}: non-finite score {score}")
    if rescored == score:
        held = "bit for bit"
    elif abs(rescored - score) <= 1e-12 * abs(score):
        held = (f"within a relative 1e-12, not bit for bit (|diff| "
                f"{abs(rescored - score)})")
    else:
        fail(f"{label}: solve score {score} != plain rescore {rescored}")
    if not score < start:
        fail(f"{label}: best {score} does not improve on the start {start}")
    print(f"{label} solve: {steps_run} steps x {n_isl} islands x "
          f"{recs[0]['moves'] // (n_isl * recs[0]['steps'])} moves in "
          f"{solve_s:.3f} s, path plain; initial best {start} -> best "
          f"{score} (= plain rescore on the card, {held})", flush=True)
    rate_line(label, card, recs, n_isl)


def exact_phase(card, steps=20, rows=1024):
    """Phase 13: `exact_fp_scores=True` on the flagship."""
    import torch
    from greyjack_tpu_torch.models.vrp import (CotwinBuilder, DomainBuilder,
                                               generate_instance)
    from greyjack_tpu_torch.models.vrp import delta_kernel as dk
    from greyjack_tpu_torch.score_calculation.score_requesters import (
        ScoreRequester)
    from greyjack_tpu_torch.solver import (Solver, SolverLoggingLevels,
                                           SolverMetrics)
    from greyjack_tpu_torch.solver.solver import island_generators

    exact_cb = CotwinBuilder(True, True, exact_fp_scores=True)
    reqs = {dev: ScoreRequester(exact_cb.build_cotwin(generate_instance(
        N_CUSTOMERS, N_DEPOTS, K_VEHICLES, seed=SEED, time_windowed=True,
        device=dev), False)) for dev in (DEVICE, "cpu")}
    if reqs[DEVICE].supports_delta:
        fail("exact: the exact cotwin registered delta kernels")
    # 1,024 rows: perturbed greedy bases and uniform samples
    bases = perturbed_bases(reqs["cpu"], rows // 2, seed=23)
    gens = island_generators(23, 1, "cpu")
    pop = torch.cat([bases, reqs["cpu"].variables_manager.sample_variables(
        gens[0], rows - rows // 2)])
    want = reqs["cpu"].request_score_plain(pop)
    got = reqs[DEVICE].request_score_plain(pop.to(DEVICE)).cpu()
    if not torch.equal(got, want):
        e = float((got - want).abs().max())
        fail(f"exact: card and CPU exact scores differ (max |diff| {e})")
    # the fast walk too: its f64 rows are the same card vs CPU
    fast = {dev: ScoreRequester(CotwinBuilder(True, True).build_cotwin(
        generate_instance(N_CUSTOMERS, N_DEPOTS, K_VEHICLES, seed=SEED,
                          time_windowed=True, device=dev), False))
        for dev in (DEVICE, "cpu")}
    pop_d = pop.to(DEVICE)
    fast_rows = fast[DEVICE].request_score_plain(pop_d).cpu()
    if not torch.equal(fast_rows, fast["cpu"].request_score_plain(pop)):
        fail("exact: the fast plain scores differ card vs CPU")
    e_ms, e_all = cuda_ms(lambda: reqs[DEVICE].request_score_plain(pop_d),
                          reps=5, inner=3)
    f_ms, f_all = cuda_ms(lambda: fast[DEVICE].request_score_plain(pop_d),
                          reps=5, inner=3)
    n_diff = int((fast_rows[:, 2] != want[:, 2]).sum())
    print(f"exact parity: {rows} rows, exact and fast plain scores each "
          f"bit-equal card vs CPU; the exact soft level differs from the "
          f"fast integer-milli walk's in {n_diff} rows (last bits)",
          flush=True)
    print(f"exact score time [{card}] at {rows} rows: exact fold {e_ms:.3f} "
          f"ms a call (runs {[round(t, 3) for t in e_all]}), fast walk "
          f"{f_ms:.3f} ms (runs {[round(t, 3) for t in f_all]})", flush=True)

    metrics = SolverMetrics()
    dk._call_kernel.launches = 0
    t0 = time.perf_counter()
    sol = Solver.solve(DomainBuilder.from_generator(flagship_domain),
                       exact_cb, plain_agent("GA", steps), N_ISLANDS, seed=0,
                       logging_level=SolverLoggingLevels.Silent,
                       metrics=metrics)
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    recs = metrics.records
    paths = {r["kernel_path"] for r in recs}
    if paths != {"plain"}:
        fail(f"exact GA: the solve ran path(s) {paths}, not plain")
    if dk._call_kernel.launches != 0:
        fail("exact GA: the solve launched the delta kernel")
    score = [sol[1]["hard_score"], sol[1]["medium_score"],
             sol[1]["soft_score"]]
    values = torch.tensor([[v for _, v in sol[0]]], dtype=torch.float32,
                          device=DEVICE)
    rescored = reqs[DEVICE].request_score_plain(values)[0].tolist()
    if rescored != score:
        fail(f"exact GA: solve score {score} != exact rescore {rescored}")
    print(f"exact GA solve: {sum(r['steps'] for r in recs)} steps x "
          f"{N_ISLANDS} islands x {GA_POP} moves in {solve_s:.3f} s, path "
          f"plain; best {score} (= exact plain rescore)", flush=True)
    rate_line("exact GA", card, recs, N_ISLANDS)


class StopAt(Exception):
    pass


class StopObserver:
    """Stops a solve, as a kill would, when chunk `chunk`'s metrics land
    (before that chunk's checkpoint is written)."""

    def __init__(self, chunk):
        self.chunk = chunk

    def update(self, solution):
        pass

    def update_metrics(self, record):
        if record["chunk"] == self.chunk:
            raise StopAt()


def resume_phase(card, steps=40):
    """Phase 14: checkpoint / resume on the int-delta flagship; returns the
    delta kernel's launches in the two runs."""
    import shutil
    import tempfile
    import torch
    from greyjack_tpu_torch.models.vrp import CotwinBuilder, DomainBuilder
    from greyjack_tpu_torch.models.vrp import delta_kernel as dk
    from greyjack_tpu_torch.solver import (Solver, SolverLoggingLevels,
                                           SolverMetrics)
    from greyjack_tpu_torch.solver.checkpoint import load_checkpoint

    def solve(**kw):
        metrics = SolverMetrics()
        sol = Solver.solve(DomainBuilder.from_generator(flagship_domain),
                           CotwinBuilder(True, True), flagship_agent(steps),
                           N_ISLANDS, seed=0,
                           logging_level=SolverLoggingLevels.Silent,
                           metrics=metrics, **kw)
        torch.cuda.synchronize()
        return sol, metrics.records

    dk._call_kernel.launches = 0
    want, recs = solve()
    full_launches = dk._call_kernel.launches
    tmp = tempfile.mkdtemp(prefix="gj_ckpt_")
    try:
        ckpt = os.path.join(tmp, "solve.ckpt")
        try:
            solve(checkpoint_path=ckpt, checkpoint_frequency=1,
                  observers=[StopObserver(3)])
            fail("resume: the stopped solve ran to its end")
        except StopAt:
            pass
        held = load_checkpoint(ckpt)["chunk_id"]
        if held != 3:
            fail(f"resume: the checkpoint holds chunk_id {held}, not 3")
        dk._call_kernel.launches = 0
        got, r_recs = solve(resume_from=ckpt)
        resumed_launches = dk._call_kernel.launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if {r["kernel_path"] for r in recs + r_recs} != {"int-delta"}:
        fail("resume: a run left the int-delta path")
    if full_launches <= 0 or resumed_launches <= 0:
        fail(f"resume: kernel launches {full_launches} (uninterrupted), "
             f"{resumed_launches} (resumed)")
    if got != want:
        fail(f"resume: resumed solve {got[1]} != uninterrupted {want[1]} "
             "(score or values differ)")
    if [r["global_best"] for r in r_recs] != [r["global_best"]
                                             for r in recs[3:]]:
        fail("resume: the resumed chunks' global bests differ")
    score, start = check_solution(got, "resume")
    print(f"resume: {steps} steps x {N_ISLANDS} islands x {NEIGHBOURS} "
          f"neighbours, path int-delta; stopped when chunk 3's metrics "
          f"landed, resumed from the checkpoint of chunks 0-2: score {score} "
          f"and {len(got[0])} values equal the uninterrupted solve's, bit "
          f"for bit; kernel launches {full_launches} uninterrupted, "
          f"{resumed_launches} resumed", flush=True)
    rate_line("resume (uninterrupted)", card, recs, N_ISLANDS)
    return full_launches + resumed_launches

# --- phases 15-17: the TSP and N-Queens models -------------------------------

def same_trees(label, want, got, prefix=""):
    """Fail unless every leaf of `got` (card) equals the leaf of `want`
    (CPU) bit for bit, dtype and shape included; returns the leaf count."""
    import torch

    if isinstance(want, dict):
        if set(want) != set(got):
            fail(f"{label}: keys differ {set(want) ^ set(got)}")
        return sum(same_trees(label, want[k], got[k], f"{prefix}/{k}")
                   for k in want)
    if isinstance(want, (list, tuple)):
        return sum(same_trees(label, w, g, f"{prefix}[{i}]")
                   for i, (w, g) in enumerate(zip(want, got)))
    g = got.cpu()
    if g.dtype != want.dtype or g.shape != want.shape \
            or not torch.equal(g, want):
        fail(f"{label}: {prefix} differs on the card ({g.dtype}"
             f"{tuple(g.shape)} vs {want.dtype}{tuple(want.shape)})")
    return 1


def tsp_domain(dev=DEVICE):
    from greyjack_tpu_torch.models.tsp import generate_uniform_instance
    return generate_uniform_instance(TSP_N, seed=TSP_SEED, device=dev)


def tsp_requester(dev=DEVICE, exact=False):
    from greyjack_tpu_torch.models.tsp import CotwinBuilder
    from greyjack_tpu_torch.score_calculation.score_requesters import (
        ScoreRequester)
    return ScoreRequester(CotwinBuilder(True, True, exact).build_cotwin(
        tsp_domain(dev), False))


def tsp_bases(req, n_isl, seed, n_moves=8):
    """The greedy tour with a few seeded swaps per island, and a
    duplicated stop on every other island."""
    import numpy as np
    import torch

    init = req.variables_manager.initial_values.cpu().numpy()
    out = []
    for i in range(n_isl):
        rng = np.random.default_rng(seed + i)
        b = init.copy()
        for _ in range(n_moves):
            x, y = rng.integers(len(b), size=2)
            b[x], b[y] = b[y], b[x]
        if i % 2:
            b[rng.integers(len(b))] = b[rng.integers(len(b))]
        out.append(b)
    return torch.from_numpy(np.stack(out))


def reversal_winners(bases, seed):
    """A full-width winner delta per island (width N, as the sweep emits):
    the reversal of a random span of at least half the tour."""
    import numpy as np
    import torch

    n_isl, n = bases.shape
    rng = np.random.default_rng(seed)
    pos = np.tile(np.arange(n, dtype=np.int32), (n_isl, 1))
    vals = bases.numpy().copy()
    valid = np.zeros((n_isl, n), bool)
    for i in range(n_isl):
        a = int(rng.integers(0, n // 2))
        b = int(rng.integers(a + n // 2, n))
        span = b - a + 1
        pos[i, :span] = np.arange(a, b + 1)
        vals[i, :span] = bases[i, a:b + 1].numpy()[::-1]
        valid[i, :span] = True
    return {"positions": torch.from_numpy(pos),
            "values": torch.from_numpy(vals),
            "valid": torch.from_numpy(valid)}


def tsp_parity(card, seed=21):
    """Phase 15: the TSP model on the card vs on the CPU at n=1000, the
    same inputs made on the CPU and moved over; then the stage times."""
    import numpy as np
    import torch
    from greyjack_tpu_torch.models.tsp import cotwin_builder as tcb
    from greyjack_tpu_torch.models.tsp import sweep as tsw
    from greyjack_tpu_torch.ops import moves
    from greyjack_tpu_torch.solver.solver import island_generators

    reqs = {dev: tsp_requester(dev) for dev in (DEVICE, "cpu")}
    exact = {dev: tsp_requester(dev, exact=True) for dev in (DEVICE, "cpu")}
    cpu = reqs["cpu"]
    rng = np.random.default_rng(seed)
    n = TSP_N - 1
    rows = torch.from_numpy(np.stack(
        [rng.permutation(np.arange(1, TSP_N)) for _ in range(1024)]
    ).astype(np.float32))
    bases = tsp_bases(cpu, N_ISLANDS, seed)
    gens = island_generators(seed, N_ISLANDS, "cpu")
    vm = cpu.variables_manager
    mcfg = moves.MoverConfig(vm, TSP_TABU, None, None)      # six moves
    deltas, _ = moves.move_population_delta(
        gens, bases, TSP_NEIGHBOURS, vm, mcfg, mcfg.init_tabu_state(N_ISLANDS))
    winners = reversal_winners(bases, seed)
    t = TSP_TARGETS
    sweep_in = (bases[:2],
                torch.from_numpy(np.stack([rng.permutation(n)[:t]
                                           for _ in range(2)]).astype(
                                               np.int32)),
                torch.from_numpy(rng.random((2, t)) < 0.9),
                torch.from_numpy(rng.random((2, n)) < 0.2))
    out = {}
    for dev, req in reqs.items():
        utils = req._delta_utils()
        cfg = tsw.SweepConfig(req, t)
        ctx = req.build_base_ctx(bases.to(dev))
        b2, t_rows, t_valid, row_tabu = (x.to(dev) for x in sweep_in)
        ctx2 = req.build_base_ctx(b2)
        out[dev] = {
            "plain_fast": req.request_score_plain(rows.to(dev)),
            "plain_exact": exact[dev].request_score_plain(rows.to(dev)),
            "ctx": ctx,
            "score_delta": req.request_score_delta(
                ctx, to_device(deltas, dev)),
            "update_ctx": req.update_ctx(ctx, to_device(winners, dev)),
            "families": tsw.score_candidates(ctx2, t_rows, t_valid,
                                             row_tabu, cfg, utils),
            "propose": tsw.propose_from_targets(ctx2, t_rows, t_valid,
                                                row_tabu, cfg, utils),
        }
    torch.cuda.synchronize()
    n_leaves = same_trees("tsp parity", out["cpu"], out[DEVICE])
    want = out["cpu"]
    # the rows are real: delta rows equal a plain rescore of the patched
    # tours, the updated ctx is the patched tour's, the winners exist
    patched = moves.apply_delta(bases, {k: v[:, 0] for k, v in
                                        deltas.items()})
    if not torch.equal(want["score_delta"][:, 0],
                       cpu.request_score_plain(patched)):
        fail("tsp parity: score_delta differs from a plain rescore")
    rebuilt = cpu.build_base_ctx(moves.apply_delta(bases, winners))
    same_trees("tsp parity (rebuilt ctx)", rebuilt, want["update_ctx"])
    if (want["propose"][1][:, 0] == 2 ** 31 - 1).any():
        fail("tsp parity: a sweep island found no valid candidate")
    print(f"tsp parity: n={TSP_N}: fast and exact plain scores of 1024 "
          f"permutation rows, the ctx of {N_ISLANDS} islands, score_delta "
          f"rows of {N_ISLANDS} x {TSP_NEIGHBOURS} six-move neighbours (kd "
          f"{deltas['positions'].shape[-1]}), update_ctx of full-width "
          f"winners ({int(winners['valid'].sum(-1).min())}-"
          f"{int(winners['valid'].sum(-1).max())} valid of {n}), the four "
          f"sweep families and propose_from_targets for 2 islands x {t} "
          f"targets: {n_leaves} arrays bit-equal, card vs CPU", flush=True)

    # stage times on the card at the main path's shapes: 8 islands x 64
    # targets, the whole-tour winner
    req = reqs[DEVICE]
    utils = req._delta_utils()
    cfg = tsw.SweepConfig(req, t)
    ctx = req.build_base_ctx(bases.to(DEVICE))
    t_rows = torch.from_numpy(np.stack([rng.permutation(n)[:t]
                                        for _ in range(N_ISLANDS)]).astype(
                                            np.int32)).to(DEVICE)
    t_valid = torch.ones((N_ISLANDS, t), dtype=torch.bool, device=DEVICE)
    no_tabu = torch.zeros((N_ISLANDS, n), dtype=torch.bool, device=DEVICE)
    delta, _, _, _ = tsw.propose_from_targets(ctx, t_rows, t_valid, no_tabu,
                                              cfg, utils)
    w = to_device(winners, DEVICE)
    d_dev = to_device(deltas, DEVICE)
    times = {
        "score_candidates": cuda_ms(lambda: tsw.score_candidates(
            ctx, t_rows, t_valid, no_tabu, cfg, utils), inner=5),
        "propose_from_targets": cuda_ms(lambda: tsw.propose_from_targets(
            ctx, t_rows, t_valid, no_tabu, cfg, utils), inner=5),
        "update_ctx (full-width winner)": cuda_ms(
            lambda: tcb.update_ctx(ctx, w, utils), inner=5),
        "update_ctx (sweep winner)": cuda_ms(
            lambda: tcb.update_ctx(ctx, delta, utils), inner=5),
        "apply_delta (sweep winner)": cuda_ms(
            lambda: moves.apply_delta(bases.to(DEVICE), delta), inner=5),
        f"score_delta ({TSP_NEIGHBOURS} x kd 16)": cuda_ms(
            lambda: req.request_score_delta(ctx, d_dev), inner=5),
    }
    print(f"tsp stage times [{card}], {N_ISLANDS} islands (event-timed, "
          "median of 7 x 5 calls, host dispatch included): " + "; ".join(
              f"{k} {v[0]:.4f} ms" for k, v in times.items()), flush=True)


def tsp_agent(label, steps):
    """Phase 16's agents at the TSP example's configuration
    (`examples/tsp_example.py`): 64 sweep targets, tabu rate 0.5; the
    random-move TabuSearch with 1024 neighbours and five move types."""
    from greyjack_tpu_torch.agents import LateAcceptance, TabuSearch
    from greyjack_tpu_torch.agents.termination_strategies import StepsLimit

    lim = StepsLimit(steps - 1)
    if label == "TSP-TS-sweep":
        return TabuSearch(TSP_NEIGHBOURS, TSP_TABU, True, None, TSP_PROBAS,
                          CHUNK_STEPS, lim, sweep=True,
                          sweep_targets=TSP_TARGETS)
    if label == "TSP-LA-sweep":
        return LateAcceptance(LA_SIZE, TSP_TABU, None, TSP_PROBAS,
                              CHUNK_STEPS, lim, sweep=True,
                              sweep_targets=TSP_TARGETS)
    return TabuSearch(TSP_NEIGHBOURS, TSP_TABU, True, None, TSP_PROBAS,
                      CHUNK_STEPS, lim)


# phase 16: (label, steps, path)
TSP_SOLVES = [("TSP-TS-sweep", 200, "sweep"), ("TSP-LA-sweep", 200, "sweep"),
              ("TSP-TS-random", 100, "delta")]


def tsp_solve(card, label, steps, path):
    """Phase 16: one TSP solve through `Solver.solve` at n=1000 (greedy
    start, 8 islands, score_precision [3, 3])."""
    import torch
    from greyjack_tpu_torch.agents.base import make_score_fn
    from greyjack_tpu_torch.models.tsp import CotwinBuilder, DomainBuilder
    from greyjack_tpu_torch.models.vrp import delta_kernel as dk
    from greyjack_tpu_torch.solver import (Solver, SolverLoggingLevels,
                                           SolverMetrics)

    db = DomainBuilder.from_generator(tsp_domain)
    metrics = SolverMetrics()
    dk._call_kernel.launches = 0
    t0 = time.perf_counter()
    sol = Solver.solve(db, CotwinBuilder(True, True), tsp_agent(label, steps),
                       N_ISLANDS, score_precision=TSP_PRECISION, seed=0,
                       logging_level=SolverLoggingLevels.Silent,
                       metrics=metrics)
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    recs = metrics.records
    paths = {r["kernel_path"] for r in recs}
    if paths != {path}:
        fail(f"{label}: the solve ran path(s) {paths}, not {path}")
    steps_run = sum(r["steps"] for r in recs)
    if steps_run < steps or recs[-1]["n_alive"] != 0:
        fail(f"{label}: the solve ran {steps_run} steps")
    if path == "sweep" and recs[-1]["sweep_scored"] <= 0:
        fail(f"{label}: the sweep solve scored no candidate")
    if dk._call_kernel.launches != 0:
        fail(f"{label}: the solve launched the VRP delta kernel")
    score = [sol[1]["hard_score"], sol[1]["soft_score"]]
    domain = db.build_from_solution(sol)
    if score[0] != 0.0 or domain.get_unique_stops_count() != TSP_N - 1:
        fail(f"{label}: hard score {score[0]}, "
             f"{domain.get_unique_stops_count()} unique stops")
    req = tsp_requester()
    values = torch.tensor([[v for _, v in sol[0]]], dtype=torch.float32,
                          device=DEVICE)
    rescored = make_score_fn(req, TSP_PRECISION)(values)[0].tolist()
    if rescored != score:
        fail(f"{label}: solve score {score} != rounded plain rescore "
             f"{rescored}")
    greedy = db.build_domain_from_scratch()
    greedy.trip_path = req.variables_manager.initial_values.long().tolist()
    start = make_score_fn(req, TSP_PRECISION)(
        req.variables_manager.initial_values[None])[0].tolist()
    if domain.get_travel_distance() > greedy.get_travel_distance():
        fail(f"{label}: tour {domain.get_travel_distance()} is longer than "
             f"the greedy tour's {greedy.get_travel_distance()}")
    extra = (f", exact counter {recs[-1]['sweep_scored']} scored "
             f"candidates" if path == "sweep" else "")
    print(f"{label} solve: {steps_run} steps x {N_ISLANDS} islands in "
          f"{solve_s:.3f} s, path {path}, VRP kernel launches 0{extra}; "
          f"greedy start {start} -> best {score} (= rounded plain rescore), "
          f"{domain.get_unique_stops_count()} unique stops, tour "
          f"{domain.get_travel_distance():.3f} vs greedy "
          f"{greedy.get_travel_distance():.3f}", flush=True)
    rate_line(label, card, recs, N_ISLANDS)


def nqueens_phase(card, seed=23):
    """Phase 17: N-Queens at 256 queens, seed 45: the plain scores and the
    ctx / score_delta rows of 8 x 20 swap neighbourhoods card vs CPU; the
    example's TabuSearch to ScoreLimit(0); GA, 8 x 128, 200 steps."""
    import numpy as np
    import torch
    from greyjack_tpu_torch.agents import GeneticAlgorithm, TabuSearch
    from greyjack_tpu_torch.agents.termination_strategies import (
        ScoreLimit, StepsLimit)
    from greyjack_tpu_torch.models.nqueens import CotwinBuilder, DomainBuilder
    from greyjack_tpu_torch.models.vrp import delta_kernel as dk
    from greyjack_tpu_torch.ops import moves
    from greyjack_tpu_torch.score_calculation.score_requesters import (
        ScoreRequester)
    from greyjack_tpu_torch.score_calculation.scores import SimpleScore
    from greyjack_tpu_torch.solver import (Solver, SolverLoggingLevels,
                                           SolverMetrics)
    from greyjack_tpu_torch.solver.solver import island_generators

    reqs = {dev: ScoreRequester(CotwinBuilder(True).build_cotwin(
        DomainBuilder(NQ_N, NQ_SEED, device=dev).build_domain_from_scratch(),
        False)) for dev in (DEVICE, "cpu")}
    vm = reqs["cpu"].variables_manager
    rng = np.random.default_rng(seed)
    rows = torch.from_numpy(rng.integers(0, NQ_N, size=(1024, NQ_N)).astype(
        np.float32))
    bases = torch.from_numpy(np.stack([rng.permutation(NQ_N)
                                       for _ in range(N_ISLANDS)]).astype(
                                           np.float32))
    gens = island_generators(seed, N_ISLANDS, "cpu")
    mcfg = moves.MoverConfig(vm, 0.0, None, NQ_PROBAS)
    deltas, _ = moves.move_population_delta(
        gens, bases, NQ_NEIGHBOURS, vm, mcfg, mcfg.init_tabu_state(N_ISLANDS))
    out = {}
    for dev, req in reqs.items():
        ctx = req.build_base_ctx(bases.to(dev))
        d = to_device(deltas, dev)
        out[dev] = {"plain": req.request_score_plain(rows.to(dev)),
                    "ctx": ctx, "score_delta": req.request_score_delta(ctx, d),
                    "update_ctx": req.update_ctx(
                        ctx, {k: v[:, 0] for k, v in d.items()})}
    torch.cuda.synchronize()
    n_leaves = same_trees("nqueens parity", out["cpu"], out[DEVICE])
    print(f"nqueens parity: {NQ_N} queens: plain scores of 1024 rows, the "
          f"ctx, score_delta rows of {N_ISLANDS} x {NQ_NEIGHBOURS} swap "
          f"neighbours and update_ctx: {n_leaves} arrays bit-equal, card vs "
          f"CPU", flush=True)

    db = DomainBuilder(NQ_N, NQ_SEED, device=DEVICE)
    board0 = db.build_domain_from_scratch().conflict_count()
    for label, agent, path in (
            ("NQ-TS", TabuSearch(NQ_NEIGHBOURS, 0.0, True, None, NQ_PROBAS,
                                 CHUNK_STEPS, ScoreLimit(SimpleScore(0.0))),
             "delta"),
            ("NQ-GA", GeneticAlgorithm(GA_POP, 0.5, 0.05, 0.0, None,
                                       NQ_PROBAS, 0.1, CHUNK_STEPS,
                                       StepsLimit(SOLVE_STEPS - 1)),
             "plain")):
        metrics = SolverMetrics()
        dk._call_kernel.launches = 0
        t0 = time.perf_counter()
        sol = Solver.solve(db, CotwinBuilder(True), agent, N_ISLANDS, seed=0,
                           logging_level=SolverLoggingLevels.Silent,
                           metrics=metrics)
        torch.cuda.synchronize()
        solve_s = time.perf_counter() - t0
        recs = metrics.records
        paths = {r["kernel_path"] for r in recs}
        if paths != {path}:
            fail(f"{label}: the solve ran path(s) {paths}, not {path}")
        if dk._call_kernel.launches != 0:
            fail(f"{label}: the solve launched the VRP delta kernel")
        conflicts = db.build_from_solution(sol).conflict_count()
        if conflicts != sol[1]["simple_value"]:
            fail(f"{label}: score {sol[1]} but {conflicts} conflicts")
        if label == "NQ-TS" and conflicts != 0:
            fail(f"{label}: ended with {conflicts} conflicts")
        if conflicts > board0:
            fail(f"{label}: {conflicts} conflicts, worse than the shuffled "
                 f"board's {board0}")
        steps_run = sum(r["steps"] for r in recs)
        print(f"{label} solve: {steps_run} steps x {N_ISLANDS} islands in "
              f"{solve_s:.3f} s, path {path}; shuffled board {board0} "
              f"conflicts -> {conflicts}", flush=True)
        rate_line(label, card, recs, N_ISLANDS)


# --- phases 18-22: the mesh, partitioned facts, service, native IO, entry ----

class CollectiveClock:
    """CUDA events around the runner's migration (`_ring`: the ring's
    boundary all_gather and the shift) and global reduce (`_update_global`:
    the tops' all_gather, the reduce and the adoption) while active; the
    summed device ms are read after the solve."""

    def __init__(self):
        from greyjack_tpu_torch.parallel import IslandRunner
        self.cls = IslandRunner
        self.orig = {name: getattr(IslandRunner, name)
                     for name in ("_ring", "_update_global")}
        self.pairs = []

    def __enter__(self):
        import torch

        def timed(name):
            orig = self.orig[name]

            def fn(runner, *a, **k):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = orig(runner, *a, **k)
                end.record()
                self.pairs.append((start, end))
                return out
            return fn

        for name in self.orig:
            setattr(self.cls, name, timed(name))
        return self

    def __exit__(self, *exc):
        for name, fn in self.orig.items():
            setattr(self.cls, name, fn)

    def total_ms(self):
        import torch
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in self.pairs)


def steady_rate(recs):
    steady = recs[1:] or recs
    wall = sum(r["wall_ms"] for r in steady) / 1e3
    return sum(r["moves"] for r in steady) / wall if wall > 0 else 0.0


def mesh_solve(card, mesh, label, agent, n_isl, want, want_recs, want_coll,
               path):
    """One flagship solve through `Solver.solve(mesh=...)`: it must equal
    the `mesh=None` solve of the same seed (`want`, its records and its
    migration + global reduce ms a chunk), report `path`, and return the
    kernel launches it made."""
    import torch
    import torch.distributed as dist
    from greyjack_tpu_torch.models.vrp import CotwinBuilder, DomainBuilder
    from greyjack_tpu_torch.models.vrp import delta_kernel as dk
    from greyjack_tpu_torch.solver import (Solver, SolverLoggingLevels,
                                           SolverMetrics)

    metrics = SolverMetrics()
    dk._call_kernel.launches = 0
    with CollectiveClock() as clock:
        sol = Solver.solve(DomainBuilder.from_generator(flagship_domain),
                           CotwinBuilder(True, True), agent, n_isl, seed=0,
                           logging_level=SolverLoggingLevels.Silent,
                           metrics=metrics, mesh=mesh)
        torch.cuda.synchronize()
        coll_ms = clock.total_ms()
    launches = dk._call_kernel.launches
    recs = metrics.records
    paths = {r["kernel_path"] for r in recs}
    if paths != {path}:
        fail(f"mesh {label}: the solve ran path(s) {paths}, not {path}")
    if sol != want:
        fail(f"mesh {label}: the solve {sol[1]} differs from the mesh=None "
             f"solve {want[1]} (score or values)")
    if [r["global_best"] for r in recs] != [r["global_best"]
                                           for r in want_recs]:
        fail(f"mesh {label}: the chunks' global bests differ from mesh=None")
    score, _ = check_solution(sol, f"mesh {label}")
    print(f"mesh {label}: {len(recs)} chunks x {n_isl} islands on a "
          f"{mesh.size}-rank {dist.get_backend()} world, path {path}, kernel launches {launches}; score "
          f"{score} and {len(sol[0])} values equal the mesh=None solve's, "
          f"bit for bit, and so do all {len(recs)} chunks' global bests",
          flush=True)
    print(f"mesh {label} rate [{card}]: {steady_rate(recs):.1f} scored "
          f"moves/s without chunk 0 (mesh=None in this run: "
          f"{steady_rate(want_recs):.1f}); migration + global reduce "
          f"{coll_ms / len(recs):.4f} ms a chunk (mesh=None: "
          f"{want_coll:.4f}; CUDA events, {len(clock.pairs)} spans); chunk "
          f"ms "
          f"{[r['wall_ms'] for r in recs]}", flush=True)
    return launches


def mesh_phase(card, mesh, int_delta, sweep):
    """Phase 18: the int-delta, sweep and GA flagship solves through
    `Solver.solve(mesh=...)` on a 1-rank NCCL world, each equal to the
    mesh=None solve of the same seed (phases 3 and 7 for the first two);
    returns the delta kernel's launches."""
    import torch.distributed as dist
    from greyjack_tpu_torch.solver import SolverMetrics

    want_backend = "nccl" if DEVICE == "cuda" else "gloo"
    if dist.get_backend() != want_backend or mesh.device.type != DEVICE:
        fail(f"phase 18: the mesh runs {dist.get_backend()} on "
             f"{mesh.device}, not {want_backend} on {DEVICE}")
    launches = mesh_solve(card, mesh, "int-delta", flagship_agent(SOLVE_STEPS),
                          N_ISLANDS, *int_delta, "int-delta")
    if launches <= 0 and DEVICE == "cuda":
        fail("mesh int-delta: the solve never launched the delta kernel")
    mesh_solve(card, mesh, "sweep", flagship_agent(SOLVE_STEPS, sweep=True),
               N_ISLANDS, *sweep, "sweep")
    ga_metrics = SolverMetrics()
    with CollectiveClock() as clock:
        ga = solve_flagship(None, ga_metrics, agent=plain_agent("GA", 50))
        ga_coll = clock.total_ms() / len(ga_metrics.records)
    mesh_solve(card, mesh, "GA", plain_agent("GA", 50), N_ISLANDS, ga,
               ga_metrics.records, ga_coll, "plain")
    return launches


def partitioned_phase(card, mesh):
    """Phase 19: the partitioned plain score at F = 1 (this rank's facts
    group alone) of 1,024 rows of the flagship and of the TSP at n=1000,
    bit-equal to the dense score, each timed."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from greyjack_tpu_torch.models.vrp import CotwinBuilder
    from greyjack_tpu_torch.ops import partitioned
    from greyjack_tpu_torch.parallel.mesh import make_island_mesh
    from greyjack_tpu_torch.score_calculation.score_requesters import (
        ScoreRequester)
    from greyjack_tpu_torch.solver.solver import island_generators

    grid = make_island_mesh(group=mesh.group, facts=1)
    vreq = ScoreRequester(CotwinBuilder(True, True).build_cotwin(
        flagship_domain(), False))
    gen = island_generators(19, 1, DEVICE)[0]
    vrows = vreq.variables_manager.sample_variables(gen, 1024)
    rng = np.random.default_rng(19)
    trows = torch.from_numpy(np.stack(
        [rng.permutation(np.arange(1, TSP_N)) for _ in range(1024)]
    ).astype(np.float32)).to(DEVICE)
    for label, req, rows in (("VRP flagship", vreq, vrows),
                             ("TSP n=1000", tsp_requester(), trows)):
        fn = req.partitioned_plain_score_fn(grid.facts_group)
        dm = req.cotwin.score_calculator.utility_objects[
            "distance_matrix_milli"]
        block, _ = partitioned.shard_rows_flat(dm, 1)
        got = fn(block, rows)
        want = req.request_score_plain(rows)
        if got.dtype != torch.float64 or not torch.equal(got, want):
            fail(f"partitioned {label}: the partitioned score differs from "
                 "the dense one")
        p_ms, p_all = cuda_ms(lambda: fn(block, rows), inner=3)
        d_ms, d_all = cuda_ms(lambda: req.request_score_plain(rows), inner=3)
        print(f"partitioned {label} [{card}]: 1024 rows, F = 1 on a 1-rank "
              f"{dist.get_backend()} facts group, bit-equal to the dense score; partitioned "
              f"{p_ms:.4f} ms a call (runs {[round(t, 4) for t in p_all]}), "
              f"dense {d_ms:.4f} ms (runs {[round(t, 4) for t in d_all]})",
              flush=True)


def service_phase(card):
    """Phase 20: the flagship's task JSON POSTed to `HttpBroker(port=0)`,
    solved by `SolverService.serve_one` with the sweep TabuSearch (3
    chunks), its solutions streamed back over HTTP."""
    import json
    import urllib.request
    import warnings
    import torch
    from greyjack_tpu_torch.service import HttpBroker, SolverService
    from greyjack_tpu_torch.service.solver_service import domain_to_task_json
    from greyjack_tpu_torch.utils.math_utils import round_decimal_t
    from greyjack_tpu_torch.solver import SolverLoggingLevels

    broker = HttpBroker(port=0)
    try:
        base = f"http://127.0.0.1:{broker.port}"
        task = domain_to_task_json(flagship_domain())
        req = urllib.request.Request(f"{base}/tasks",
                                     data=json.dumps(task).encode(),
                                     method="POST")
        if urllib.request.urlopen(req, timeout=30).status != 202:
            fail("service: the broker refused the task")
        service = SolverService(
            broker, lambda: flagship_agent(3 * CHUNK_STEPS, sweep=True),
            n_jobs=N_ISLANDS, logging_level=SolverLoggingLevels.Silent,
            seed=0, device=DEVICE)
        t0 = time.perf_counter()
        with warnings.catch_warnings():
            warnings.simplefilter("error", RuntimeWarning)
            final = service.serve_one(timeout=30)
        torch.cuda.synchronize()
        solve_s = time.perf_counter() - t0
        if final is None:
            fail("service: serve_one took no task")
        streamed = []
        while True:
            got = json.loads(urllib.request.urlopen(f"{base}/solutions",
                                                    timeout=60).read())
            streamed.append(got)
            if got == "Solving finished" or len(streamed) > 100:
                break
    finally:
        broker.close()
    if streamed[-1] != "Solving finished":
        fail("service: no 'Solving finished' marker")
    solutions = [s for s in streamed if isinstance(s, dict)]
    if not solutions or solutions[-1]["solution"] != final:
        fail(f"service: {len(solutions)} solutions streamed, the last not "
             "the returned one")
    values = torch.tensor([[v for _, v in final[0]]], dtype=torch.float32,
                          device=DEVICE)
    from greyjack_tpu_torch.models.vrp import CotwinBuilder
    from greyjack_tpu_torch.score_calculation.score_requesters import (
        ScoreRequester)
    rescore_req = ScoreRequester(CotwinBuilder(True, False).build_cotwin(
        flagship_domain(), False))
    row = round_decimal_t(rescore_req.request_score_plain(values),
                          [0, 0, 3])[0].tolist()
    score = [final[1]["hard_score"], final[1]["medium_score"],
             final[1]["soft_score"]]
    if score != row:
        fail(f"service: score {score} != rounded plain rescore {row}")
    print(f"service [{card}]: task POSTed to HttpBroker on port "
          f"{broker.port}, TabuSearch sweep {3 * CHUNK_STEPS} steps x "
          f"{N_ISLANDS} islands, score_precision [0, 0, 3], served in "
          f"{solve_s:.3f} s; {len(solutions)} solutions streamed over HTTP, "
          f"then 'Solving finished'; final score {score} = rounded plain "
          f"rescore; last distance {solutions[-1]['sum_travel_distance']}",
          flush=True)


def write_vrp(domain, path):
    """A `.vrp` file of a generated plan, coordinates written with repr so
    they read back exactly."""
    lines = [f"NAME : {domain.name}", "TYPE : CVRP",
             f"DIMENSION : {len(domain.customers_vec)}",
             "EDGE_WEIGHT_TYPE : EUC_2D",
             f"CAPACITY : {domain.vehicles[0].capacity}",
             "NODE_COORD_SECTION"]
    lines += [f"{c.id} {c.latitude!r} {c.longitude!r}"
              for c in domain.customers_vec]
    lines.append("DEMAND_SECTION")
    lines += [f"{c.id} {c.demand} {c.time_window_start} {c.time_window_end} "
              f"{c.service_time}" for c in domain.customers_vec]
    lines += ["DEPOT_SECTION"] + [str(d.id) for d in domain.depot_vec]
    with open(path, "w") as f:
        f.write("\n".join(lines + ["-1", "EOF", ""]))


def write_tsp(domain, path):
    lines = [f"NAME : {domain.name}", "TYPE : TSP",
             f"DIMENSION : {len(domain.locations_vec)}",
             "EDGE_WEIGHT_TYPE : EUC_2D", "NODE_COORD_SECTION"]
    lines += [f"{lc.id} {lc.latitude!r} {lc.longitude!r}"
              for lc in domain.locations_vec]
    with open(path, "w") as f:
        f.write("\n".join(lines + ["EOF", ""]))


def same_plans(label, a, b):
    import torch

    def rows(plan):
        return [(c.id, c.vec_id, c.latitude, c.longitude, c.name, c.demand,
                 c.time_window_start, c.time_window_end, c.service_time)
                for c in plan.customers_vec]

    if rows(a) != rows(b) or a.name != b.name \
            or [(v.depot_vec_id, v.capacity, v.work_day_end)
                for v in a.vehicles] != [(v.depot_vec_id, v.capacity,
                                          v.work_day_end) for v in b.vehicles]:
        fail(f"native IO: {label}: the plans differ")
    if not torch.equal(a.distance_matrix, b.distance_matrix):
        fail(f"native IO: {label}: the distance matrices differ")


def native_phase(card):
    """Phase 21: the flagship as a `.vrp` file and the TSP at n=1000 as a
    `.tsp` file: the native tokenizer must build; its reads must equal the
    Python scans and the generated instances; then a 20-step int-delta
    solve from `DomainBuilder(vrp_file_path)` with `print_metrics`.
    Returns the delta kernel's launches."""
    import contextlib
    import io
    import shutil
    import tempfile
    import torch
    from greyjack_tpu_torch.models.tsp import DomainBuilder as TspBuilder
    from greyjack_tpu_torch.models.tsp import domain as tsp_dom
    from greyjack_tpu_torch.models.vrp import CotwinBuilder, DomainBuilder
    from greyjack_tpu_torch.models.vrp import delta_kernel as dk
    from greyjack_tpu_torch.models.vrp import domain as vrp_dom
    from greyjack_tpu_torch.native import gjio, native_available
    from greyjack_tpu_torch.solver import (Solver, SolverLoggingLevels,
                                           SolverMetrics)

    t0 = time.perf_counter()
    if not native_available():
        fail("native IO: the g++ tokenizer did not build")
    build_s = time.perf_counter() - t0
    tmp = tempfile.mkdtemp(prefix="gj_native_")
    try:
        vrp_path = os.path.join(tmp, "flagship.vrp")
        tsp_path = os.path.join(tmp, "tsp1000.tsp")
        flag = flagship_domain()
        write_vrp(flag, vrp_path)
        write_tsp(tsp_domain(), tsp_path)
        parsed = gjio.parse_instance(vrp_path)
        if parsed is None or len(parsed["ids"]) != len(flag.customers_vec):
            fail("native IO: the tokenizer did not read the flagship file")
        t0 = time.perf_counter()
        native = vrp_dom.read_vrp_file(vrp_path, device=DEVICE)
        native_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        scanned = vrp_dom.scan_vrp_file(vrp_path, device=DEVICE)
        scan_s = time.perf_counter() - t0
        same_plans("flagship native vs scan", native, scanned)
        same_plans("flagship native vs generated", native, flag)
        meta, locs, matrix = tsp_dom.read_tsp_file(tsp_path)
        smeta, slocs, smatrix = tsp_dom.scan_tsp_file(tsp_path)
        if meta != smeta or matrix is not None or smatrix is not None or [
                (lc.id, lc.latitude, lc.longitude) for lc in locs] != [
                (lc.id, lc.latitude, lc.longitude) for lc in slocs]:
            fail("native IO: the TSP reads differ")
        tdom = TspBuilder(tsp_path, device=DEVICE).build_domain_from_scratch()
        if not torch.equal(tdom.distance_matrix, tsp_domain().distance_matrix):
            fail("native IO: the TSP file's matrix differs from the "
                 "generated one")
        metrics = SolverMetrics()
        dk._call_kernel.launches = 0
        builder = DomainBuilder(vrp_path, device=DEVICE)
        sol = Solver.solve(builder, CotwinBuilder(True, True),
                           flagship_agent(20), N_ISLANDS, seed=0,
                           logging_level=SolverLoggingLevels.Silent,
                           metrics=metrics)
        torch.cuda.synchronize()
        launches = dk._call_kernel.launches
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            builder.build_from_solution(sol).print_metrics()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if {r["kernel_path"] for r in metrics.records} != {"int-delta"} \
            or (launches <= 0 and DEVICE == "cuda"):
        fail(f"native IO: the file solve ran "
             f"{ {r['kernel_path'] for r in metrics.records} } with "
             f"{launches} kernel launches")
    score, _ = check_solution(sol, "native IO")
    print(f"native IO [{card}]: g++ tokenizer {os.path.basename(gjio.library_path())} "
          f"ready in {build_s:.3f} s; flagship .vrp read natively in "
          f"{native_s:.3f} s, scanned in {scan_s:.3f} s, equal plans and "
          f"matrices (= the generated instance); TSP n=1000 .tsp native = "
          f"scan = generated; 20-step int-delta solve from the file: score "
          f"{score} (= plain rescore), kernel launches {launches}; "
          f"print_metrics: {out.getvalue().strip()!r}", flush=True)
    return launches


def entry_phase(card):
    """Phase 22: `entry()`'s step on the card against the CPU's score of
    the same rows, and `dryrun_multichip(1)` on the initialised 1-rank
    world. Returns the delta kernel's launches (the dryrun's leg 2)."""
    import torch
    from greyjack_tpu_torch import entry as gj_entry
    from greyjack_tpu_torch.models.vrp import delta_kernel as dk

    step, (pop,) = gj_entry.entry(device=DEVICE)
    got = step(pop)
    torch.cuda.synchronize()
    cpu_step, _ = gj_entry.entry(device="cpu")
    want = cpu_step(pop.cpu())
    if pop.device.type != DEVICE or tuple(got.shape) != (16, 3) \
            or not torch.equal(got.cpu(), want):
        fail("entry: the step on the card differs from the CPU's")
    dk._call_kernel.launches = 0
    gj_entry.dryrun_multichip(1)
    launches = dk._call_kernel.launches
    if launches <= 0 and DEVICE == "cuda":
        fail("entry: dryrun_multichip's leg 2 never launched the kernel")
    print(f"entry [{card}]: entry() plain score of {pop.shape[0]} rows on "
          f"the card = the CPU's, bit for bit; dryrun_multichip(1): three "
          f"legs passed, kernel launches {launches}", flush=True)
    return launches


# --- phase 23: whole solves against the JAX package, in distribution --------

def quality_phase(card):
    """Phase 23: every configuration of `tests/_torch_quality.py`, solved
    on the card for the reference file's seeds and compared with the JAX
    package's final scores. Returns the kernel's launches."""
    import torch
    from greyjack_tpu_torch.models.vrp import delta_kernel as dk

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "tests"))
    import _torch_quality as q

    ref = q.load_ref()
    total = 0
    t_phase = time.perf_counter()
    for name in q.SMALL + q.FULL:
        cfg = q.CONFIGS[name]
        dk._call_kernel.launches = 0
        solves = q.run_port(name, DEVICE, sync=torch.cuda.synchronize)
        launches = dk._call_kernel.launches
        total += launches
        paths = {p for s in solves for p in s["paths"]}
        if paths != {cfg["path"]}:
            fail(f"phase 23: {name} ran path(s) {paths}, not {cfg['path']}")
        if any(s["steps"] != cfg["steps"] for s in solves):
            fail(f"phase 23: {name} ran {[s['steps'] for s in solves]} "
                 "steps")
        kernel_path = cfg["model"] == "vrp" and cfg["path"] in ("int-delta",
                                                                "delta")
        if kernel_path and launches <= 0:
            fail(f"phase 23: {name} never launched the CUDA delta kernel")
        if not kernel_path and launches:
            fail(f"phase 23: {name} launched the delta kernel {launches} "
                 "times")
        ok, res, lines = q.check(name, solves, ref)
        secs = [s["seconds"] for s in solves]
        for ln in lines:
            print(f"quality [{card}]: {ln}", flush=True)
        print(f"quality [{card}]: {name}: {len(solves)} solves, "
              f"{statistics.median(secs):.3f} s a solve (median; min "
              f"{min(secs):.3f}, max {max(secs):.3f}), kernel launches "
              f"{launches}", flush=True)
        if not ok:
            fail(f"phase 23: {name} differs from the JAX package's solves "
                 f"at p < {q.ALPHA}: {lines}")
    print(f"quality: {len(q.SMALL) + len(q.FULL)} configurations in "
          f"{time.perf_counter() - t_phase:.1f} s, every p >= {q.ALPHA}",
          flush=True)
    return total


def profile(out_dir, path, n_chunks=3):
    """torch.profiler breakdown of `n_chunks` flagship chunks (after one
    warm-up chunk) of the int-delta, the sweep, the LateAcceptance
    random-move ("la-random", 512 islands), the GeneticAlgorithm ("ga", 8
    islands x 128), the plain TabuSearch ("ts-plain", 8 islands x 2048,
    six moves, full rescore), the plain LateAcceptance ("la-plain", 512
    islands x 1) or the LSHADE ("lshade", 8 islands x 128) path, of
    LSHADE on the mixed-int model ("mixedint-lshade", 50 floats + 50 ints,
    8 islands x 128), or of the TSP sweep ("tsp-sweep", phase 16's
    TabuSearch: n=1000, 8 islands x 64 targets, [3, 3]), with a labelled
    range around the step and each of its stages."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, record_function
    from greyjack_tpu_torch.agents import base as agent_base
    from greyjack_tpu_torch.models.vrp import CotwinBuilder
    from greyjack_tpu_torch.models.vrp import delta_kernel as dk
    from greyjack_tpu_torch.models.vrp import sweep as sw
    from greyjack_tpu_torch.ops import lexico, move_kernel, moves
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

    plain = path in ("ga", "ts-plain", "la-plain", "lshade",
                     "mixedint-lshade")
    if path == "mixedint-lshade":
        db, cb = mixed_builders()
        req = ScoreRequester(cb.build_cotwin(db.build_domain_from_scratch(),
                                             False))
    elif path == "tsp-sweep":
        req = tsp_requester()
    else:
        req = ScoreRequester(CotwinBuilder(
            path not in ("ts-plain", "la-plain"), True).build_cotwin(
            flagship_domain(), False))
    if path == "sweep":
        stages = [(sw, "sample_targets", "step.sweep.sample_targets"),
                  (sw, "build_tables", "step.sweep.build_tables"),
                  (sw, "_change_sweep", "step.sweep.family_a_change"),
                  (sw, "_vehicle_sweep", "step.sweep.family_b_vehicle"),
                  (sw, "_swap_sweep", "step.sweep.family_c_swap"),
                  (sw, "_select_winner", "step.sweep.lex_select"),
                  (sw, "_exact_rescore", "step.sweep.exact_rescore")]
    elif path == "tsp-sweep":
        from greyjack_tpu_torch.models.tsp import sweep as tsw
        stages = [(tsw, "sample_targets", "step.sweep.sample_targets"),
                  (tsw, "tabu_rows", "step.sweep.tabu_rows"),
                  (tsw, "score_candidates", "step.sweep.families"),
                  (tsw, "propose_from_targets",
                   "step.sweep.propose (families, select, decode)"),
                  (moves, "apply_delta", "step.apply_delta")]
    elif plain:
        # the plain score is a bound method the kernel captures when it is
        # built: every stage is wrapped before the build
        stages = [(moves, "island_uniforms", "step.draw"),
                  # the card's TS / LA / SA plain steps: the sampler kernel
                  # moves and fixes; GA and LSHADE run the torch body
                  (move_kernel, "move_and_fix", "step.move_kernel"),
                  (moves, "do_move", "step.move_body"),
                  # also counts the fix inside the plain score's frames
                  (req.variables_manager, "fix_all", "step.fix_all"),
                  (req, "request_score_plain", "step.plain_score"),
                  (lexico, "lex_sort_scores_with", "step.sort")]
    else:
        stages = [(moves, "move_population_delta", "step.sample"),
                  (dk, "_pre", "step.score._pre"),
                  (dk, "_call_kernel", "step.score.kernel"),
                  (dk, "_post", "step.score._post")]
    if not plain:
        stages += [(req, "update_ctx", "step.update_ctx")]
    saved = [(obj, attr, getattr(obj, attr)) for obj, attr, _ in stages]
    for obj, attr, name in stages:
        setattr(obj, attr, labelled(name, getattr(obj, attr)))
    try:
        if path == "la-random":
            kernel = mh_agent("LA", False, 10 ** 9).build_kernel(req)
            n_isl, want_path = RANDOM_ISLANDS, "delta"
        elif path == "ga":
            kernel = plain_agent("GA", 10 ** 9).build_kernel(req)
            n_isl, want_path = N_ISLANDS, "plain"
        elif path == "ts-plain":
            kernel = plain_agent("TS-plain", 10 ** 9).build_kernel(req)
            n_isl, want_path = N_ISLANDS, "plain"
        elif path == "la-plain":
            kernel = plain_agent("LA-plain", 10 ** 9).build_kernel(req)
            n_isl, want_path = RANDOM_ISLANDS, "plain"
        elif path in ("lshade", "mixedint-lshade"):
            kernel = lshade_agent(10 ** 9, mixed=path != "lshade"
                                  ).build_kernel(req)
            n_isl, want_path = N_ISLANDS, "plain"
        elif path == "tsp-sweep":
            kernel = tsp_agent("TSP-TS-sweep", 10 ** 9).build_kernel(
                req, TSP_PRECISION)
            n_isl, want_path = N_ISLANDS, "sweep"
        else:
            kernel = flagship_agent(10 ** 9, path == "sweep").build_kernel(
                req)
            n_isl, want_path = N_ISLANDS, path
        if kernel.path != want_path:
            fail(f"profile: built path {kernel.path}, not {want_path}")
        runner = IslandRunner(kernel, n_isl, CHUNK_STEPS)
        more = []
        if kernel.prestep is not None:
            more += [(kernel, "prestep", "step.tabu_free")]
        if not kernel.self_gating:
            more += [(agent_base, "mask_state", "step.mask_state")]
        more += [(kernel, "step", "step (whole)")]
        if kernel.refresh is not None:
            more += [(kernel, "refresh", "chunk.refresh")]
        more += [(runner, "_migrate", "chunk.migrate")]
        saved += [(obj, attr, getattr(obj, attr)) for obj, attr, _ in more]
        for obj, attr, name in more:
            setattr(obj, attr, labelled(name, getattr(obj, attr)))
        stages += more
        gens = island_generators(0, n_isl, req.device)
        state = runner.init(gens)
        alive = torch.ones(n_isl, dtype=torch.bool, device=req.device)
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
        for obj, attr, fn in reversed(saved):
            setattr(obj, attr, fn)
    ka = prof.key_averages()
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"profile_{path}.txt"), "w") as f:
        f.write(ka.table(sort_by="device_time_total", row_limit=80))
    # device busy = kernel and copy time; the labelled ranges also appear
    # on the device timeline, as user annotations spanning their kernels,
    # and are left out (as the profiler's own table totals do)
    dev_events = [e for e in ka if e.device_type == DeviceType.CUDA
                  and not e.is_user_annotation]
    dev_ms = sum(e.self_device_time_total for e in dev_events) / 1e3
    launches = sum(e.count for e in dev_events)
    steps = n_chunks * CHUNK_STEPS
    print(f"profile {path} [{card_line()}]: {n_isl} islands, {steps} steps "
          f"wall {wall_ms:.3f} ms ({wall_ms / steps:.3f} ms/step), device "
          f"busy {dev_ms:.3f} ms ({dev_ms / steps:.3f} ms/step, "
          f"{100 * dev_ms / wall_ms:.1f}% of wall), {launches / steps:.1f} "
          f"device ops (kernels + copies) per step", flush=True)
    for _, _, name in stages:
        rows = [e for e in ka
                if e.key == name and e.device_type == DeviceType.CPU]
        if rows:
            e = rows[0]
            per = n_chunks if name.startswith("chunk.") else steps
            unit = "chunk" if name.startswith("chunk.") else "step"
            print(f"  {name}: calls {e.count}, host "
                  f"{e.cpu_time_total / 1e3 / per:.4f} ms/{unit}, device "
                  f"{e.device_time_total / 1e3 / per:.4f} ms/{unit}",
                  flush=True)


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
    print(f"build: vrp_delta {build_s:.3f} s (nvcc {info.get('seconds', 0):.3f}"
          f" s)", flush=True)
    for ln in info.get("log", "").splitlines():
        # name each instantiation (time windows, kd, route), then its
        # registers, spills and shared memory
        m = re.search(r"vrp_delta_(shared|direct)ILb([01])ELi([12])E", ln)
        if "Compiling entry function" in ln and m:
            print(f"  ptxas: kernel route={m[1]} tw={m[2]} kd={m[3]}",
                  flush=True)
        elif "registers" in ln or "spill" in ln:
            print(f"  ptxas: {ln.strip()}", flush=True)

    # --- 2. parity ----------------------------------------------------------
    # both kernel routes at n=40 (6 vehicles): 2 islands x 512 neighbours
    # (1,536 rows an island, the shared route) and 2 islands x 1 neighbour
    # (3 rows an island, the direct route); then routes that fill
    # route_cap = Rp = 128 (n=128, 4 vehicles, every stop of island 0 on
    # vehicle 0), where inserts overflow the padded row, and route_cap =
    # 300 of Rp = 384 (n=300, 2 vehicles), too long for the shared slab
    max_err = 0
    cases = []
    for tw in (True, False):
        dom = generate_instance(40, 2, 6, seed=3, time_windowed=tw,
                                device=DEVICE)
        cases += [(f"n40 tw={tw}", dom, p, "shared" if p > 1 else "direct",
                   False) for p in (512, 1)]
    dom = generate_instance(128, 1, 4, seed=3, time_windowed=True,
                            device=DEVICE)
    cases += [(f"n128 full route p={p}", dom, p,
               "shared" if p > 1 else "direct", True) for p in (256, 1)]
    dom = generate_instance(300, 1, 2, seed=3, time_windowed=True,
                            device=DEVICE)
    cases += [(f"n300 full route p={p}", dom, p, "direct", True)
              for p in (256, 1)]
    for name, dom, p, want_route, full in cases:
        req = ScoreRequester(CotwinBuilder(True, True).build_cotwin(dom,
                                                                    False))
        ctx, deltas = neighbourhood(req, 2, p, seed=5, full_route=full)
        # kd=1: the first entry of each move alone is a one-variable change
        one = {k: v[..., :1].contiguous() for k, v in deltas.items()}
        for kd, d in ((2, deltas), (1, one)):
            e, _, _, route = compare(f"{name} kd={kd}", req, ctx, d)
            max_err = max(max_err, e)
            if route != want_route:
                fail(f"{name} kd={kd} took the {route} route")
    freq = ScoreRequester(CotwinBuilder(True, True).build_cotwin(
        flagship_domain(), False))
    ctx, deltas = neighbourhood(freq, N_ISLANDS, NEIGHBOURS, seed=7)
    e, inputs, aux, route = compare("flagship", freq, ctx, deltas)
    max_err = max(max_err, e)
    if route != "shared":
        fail(f"the flagship took the {route} route, not the shared one")
    # the random-move LA / SA shape: one neighbour per island
    ctx, deltas = neighbourhood(freq, RANDOM_ISLANDS, 1, seed=9)
    e, r_inputs, r_aux, r_route = compare(f"flagship {RANDOM_ISLANDS}x1",
                                          freq, ctx, deltas)
    max_err = max(max_err, e)
    if r_route != "direct":
        fail(f"{RANDOM_ISLANDS}x1 took the {r_route} route, not the direct "
             "one")

    # --- 3. the main path ---------------------------------------------------
    metrics = SolverMetrics()
    dk._call_kernel.launches = 0
    t0 = time.perf_counter()
    with CollectiveClock() as clock:
        sol = solve_flagship(SOLVE_STEPS, metrics)
        torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    launches = dk._call_kernel.launches
    main_coll_ms = clock.total_ms() / len(metrics.records)
    paths = {r["kernel_path"] for r in metrics.records}
    if launches <= 0:
        fail("the solve never launched the CUDA delta kernel")
    if paths != {"int-delta"}:
        fail(f"the solve ran path(s) {paths}, not int-delta")
    steps_run = sum(r["steps"] for r in metrics.records)
    if steps_run < SOLVE_STEPS:
        fail(f"the solve ran {steps_run} steps")
    score, start_score = check_solution(sol, "int-delta")
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

    # --- 4. kernel timings at both main-path shapes ---------------------------
    utils = freq._delta_utils()
    shapes = []
    for label, s_inputs, s_aux, s_route in (
            ("int-delta", inputs, aux, route),
            ("f64 random-move", r_inputs, r_aux, r_route)):
        kd, n_isl = s_aux["kd"], s_aux["n_islands"]
        rows = s_inputs[1].shape[0]
        outs = [torch.empty((rows, 8), dtype=torch.int32, device=DEVICE)
                for _ in range(4)]
        this = raw_launcher(dk._library().gj_vrp_delta,
                            dk._kernel_args(s_inputs, outs, utils, kd, n_isl))
        dev_ms, dev_all = graph_ms(this)
        print(f"kernel device time, {label} [{card}] at {rows} rows: "
              f"{dev_ms:.5f} ms (runs {[round(t, 5) for t in dev_all]})",
              flush=True)
        w_ms, w_all = cuda_ms(
            lambda: dk._call_kernel(s_inputs, utils, kd, n_isl))
        p_ms, p_all = cuda_ms(lambda: dk._kernel_reference(
            *s_inputs, kd=kd, tw=True, rows_per_island=rows // n_isl),
            inner=3)
        n_bytes, n_ops, b_ms, b_by = kernel_bound(s_inputs, utils, kd, n_isl)
        print(f"kernel time, {label} [{card}] at {rows} rows, {s_route} "
              f"route: device only (CUDA graph of raw launches) {dev_ms:.5f} "
              f"ms; with the wrapper (`_call_kernel`, event-timed) "
              f"{w_ms:.4f} ms (runs {[round(t, 4) for t in w_all]}); plain "
              f"torch {p_ms:.4f} ms (runs {[round(t, 4) for t in p_all]}); "
              f"bound {b_ms:.5f} ms by {b_by} ({n_bytes} B, {n_ops} i32 ops)"
              f", {100 * b_ms / dev_ms:.1f}% of it", flush=True)
        shapes.append({"rows": rows, "kernel_route": s_route,
                       "device_ms": dev_ms, "wrapper_ms": w_ms,
                       "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by})

    # --- 5. the sweep path ----------------------------------------------------
    sweep_parity()
    sweep_run = sweep_solve(card)

    # --- 6. LateAcceptance and SimulatedAnnealing -----------------------------
    for name in ("LA", "SA"):
        mh_solve(card, name, sweep=True)
    for name in ("LA", "SA"):
        launches += mh_solve(card, name, sweep=False)

    # --- 7. the plain (full-rescore) path -------------------------------------
    move_parity()
    sampler = sampler_phase(card)
    plain_score = plain_score_phase(card)
    sampler_launches = plain_launches = 0
    for label, n_isl, steps, delta_cotwin, path in PLAIN_SOLVES:
        sampled, scored = plain_solve(card, label, n_isl, steps,
                                      delta_cotwin, path)
        sampler_launches += sampled
        plain_launches += scored

    # --- 8. LSHADE on the flagship (docstring phase 11) -----------------------
    lshade_body_parity()
    plain_launches += lshade_solve(card, "LSHADE", N_ISLANDS, SOLVE_STEPS)
    plain_launches += lshade_solve(card, "LSHADE-wide", 64, 50)

    # --- 9. the mixed-int model (phase 12) ------------------------------------
    for label in ("mixedint-GA", "mixedint-LSHADE", "mixedint-TS-random"):
        mixed_solve(card, label)

    # --- 10. exact_fp_scores (phase 13) ---------------------------------------
    exact_phase(card)

    # --- 11. checkpoint / resume (phase 14) -----------------------------------
    launches += resume_phase(card)

    # --- 12. the TSP model (phases 15-16) -------------------------------------
    tsp_parity(card)
    for label, steps, path in TSP_SOLVES:
        tsp_solve(card, label, steps, path)

    # --- 13. N-Queens (phase 17) ----------------------------------------------
    nqueens_phase(card)

    # --- 14. phases 18-22 on a 1-rank NCCL world --------------------------
    import shutil
    import tempfile
    import torch.distributed as dist
    from greyjack_tpu_torch.parallel.mesh import init_distributed

    mesh_dir = tempfile.mkdtemp(prefix="gj_mesh_")
    try:
        mesh = init_distributed(
            "file://" + os.path.join(mesh_dir, "store"), 1, 0)
        try:
            launches += mesh_phase(card, mesh,
                                   (sol, metrics.records, main_coll_ms),
                                   sweep_run)
            partitioned_phase(card, mesh)
            service_phase(card)
            launches += native_phase(card)
            launches += entry_phase(card)
        finally:
            dist.destroy_process_group()
    finally:
        shutil.rmtree(mesh_dir, ignore_errors=True)

    # --- 15. whole solves against the JAX package (phase 23) -----------------
    launches += quality_phase(card)

    if "--profile" in argv:
        out_dir = argv[argv.index("--profile") + 1]
        for path in ("int-delta", "sweep", "la-random", "ga", "ts-plain",
                     "la-plain", "lshade", "mixedint-lshade", "tsp-sweep"):
            profile(out_dir, path)

    flag = shapes[0]
    print(json.dumps({"kernels": [{
        "name": "vrp_delta", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": launches,
        "max_abs_err": max_err, "ms": flag["device_ms"],
        "plain_ms": flag["plain_ms"], "bound_ms": flag["bound_ms"],
        "bound_by": flag["bound_by"], "library_ms": None,
        "shapes": shapes}, {
        "name": "move_sample", "route": "cuda", "source": SAMPLER_SOURCE,
        "replaces": SAMPLER_REPLACES, "launches": sampler_launches,
        "max_abs_err": 0, "ms": sampler["device_ms"],
        "plain_ms": sampler["plain_ms"], "bound_ms": sampler["bound_ms"],
        "bound_by": sampler["bound_by"], "library_ms": None,
        "shapes": [sampler]}, {
        "name": "vrp_plain", "route": "cuda", "source": PLAIN_SOURCE,
        "replaces": PLAIN_REPLACES, "launches": plain_launches,
        "max_abs_err": 0, "ms": plain_score["device_ms"],
        "plain_ms": plain_score["plain_ms"],
        "bound_ms": plain_score["bound_ms"],
        "bound_by": plain_score["bound_by"], "library_ms": None,
        "shapes": [plain_score]}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
