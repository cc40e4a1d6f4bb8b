"""Solver — the orchestration entry point (counterpart of
`greyjack_tpu/solver/solver.py`; reference `solver.rs:25-149`).

`Solver.solve` builds the domain, compiles the cotwin onto the device of the
domain's distance matrix, builds the metaheuristic's kernel, runs `n_jobs`
islands as one batch on that device, and loops over chunks of
`migration_frequency` steps with host syncs for termination, logging,
observers and metrics, until every island has terminated. Each island draws
from its own `torch.Generator`, seeded from `seed`.

LocalSearch agents (TabuSearch, LateAcceptance, SimulatedAnnealing) run one
individual an island; Population agents (GeneticAlgorithm, LSHADE) run
`population_size` an island, migrate `migration_rate` of it, and count
`population_size` moves per island-step. A solve can write checkpoints and
resume from one (`solver/checkpoint.py`), and capture a profiler trace of a
few chunks (`profile_dir`).

Under a mesh (`parallel/mesh.py`) the solve is SPMD: every rank calls
`Solver.solve` with the same builders and seed, holds the generators of
its own global islands and steps them; termination reads every island's
top, all-gathered, so all ranks keep the same strategies, alive mask and
budgets (the JAX package's single-controller read, `solver.py:212-216`).
Logging, observers, metrics and the profile run on the lead rank (rank 0);
every rank returns the same solution. A checkpoint under a mesh is the
whole state a single-device solve writes (rank 0 writes it after a
gather), and a resume under a mesh takes each rank's part of it, so either
kind of solve resumes from either kind of checkpoint.
"""

from __future__ import annotations

import datetime
import time

import numpy as np
import torch

from greyjack_tpu_torch.interop import from_numpy_tree
from greyjack_tpu_torch.parallel.islands import IslandRunner
from greyjack_tpu_torch.score_calculation.score_requesters import ScoreRequester
from greyjack_tpu_torch.solver.solver_logging_levels import SolverLoggingLevels
from greyjack_tpu_torch.agents.termination_strategies.strategies import (
    StepsLimit,
)
from greyjack_tpu_torch.solver.checkpoint import (load_checkpoint,
                                                  save_checkpoint)
from greyjack_tpu_torch.solver.metrics import ProfileCapture


def _convert_to_json(variables_manager, values_row, score_obj):
    """Solution JSON: ([[var_name, typed_value], ...], score) — reference
    `convert_to_json` (`agent_base.rs:523-535`)."""
    typed = variables_manager.inverse_transform_variables(values_row)
    names = variables_manager.get_variables_names_vec()
    return [[[n, v] for n, v in zip(names, typed)], score_obj.to_json()]


def island_generators(seed, n_islands, device):
    """One torch.Generator per island on `device`, seeded from `seed`
    through numpy's SeedSequence (independent streams)."""
    states = np.random.SeedSequence(int(seed)).generate_state(
        n_islands, dtype=np.uint64)
    gens = []
    for s in states:
        g = torch.Generator(device=device)
        g.manual_seed(int(s))
        gens.append(g)
    return gens


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Solver:
    @staticmethod
    def solve(
        domain_builder,
        cotwin_builder,
        agent_builder,
        n_jobs,
        score_precision=None,
        logging_level=SolverLoggingLevels.Info,
        observers=None,
        initial_solution=None,
        mesh=None,
        seed=None,
        checkpoint_path=None,
        checkpoint_frequency=10,
        resume_from=None,
        metrics=None,
        profile_dir=None,
    ):
        """checkpoint_path: if set, the solve state (island tree, island
        generators, termination strategies, alive mask, chunk counter,
        best solution) is written there atomically every
        `checkpoint_frequency` chunks and at termination. resume_from: a
        path (or a dict) from `checkpoint.load_checkpoint`; the program is
        rebuilt from the builders, which must match the checkpointed
        configuration, and the solve continues where it stopped.
        metrics: a `solver.metrics.SolverMetrics` collector, filled with
        one record per chunk (wall ms after the device finished, moves/s,
        best score, kernel path) and fanned out to observers implementing
        `update_metrics`. profile_dir: write a `torch.profiler` trace of
        a few chunks (`metrics.ProfileCapture`) there. mesh: a
        `parallel.mesh.IslandMesh`; every rank of it makes this call with
        the same arguments."""

        # --- domain dispatch (`solver.rs:106-119`) ------------------------
        if initial_solution is None:
            domain = domain_builder.build_domain_from_scratch()
            is_initialized = False
        elif initial_solution.kind == "cotwin_values_vector":
            domain = domain_builder.build_from_solution(initial_solution.payload)
            is_initialized = True
        elif initial_solution.kind == "domain_object":
            domain = domain_builder.build_from_domain(initial_solution.payload)
            is_initialized = True
        else:
            raise ValueError(f"Unknown initial solution kind {initial_solution.kind}")

        cotwin = cotwin_builder.build_cotwin(domain, is_initialized)
        requester = ScoreRequester(cotwin)
        score_class = requester.score_class
        device = requester.device
        lead = mesh is None or mesh.is_lead
        if mesh is not None and device.type != mesh.device.type:
            raise ValueError(f"the domain lives on {device}, the mesh's "
                             f"islands on {mesh.device}")
        if not lead:
            logging_level = SolverLoggingLevels.Silent
            observers = None

        if score_precision is not None:
            if len(score_precision) != score_class.precision_len():
                raise ValueError(
                    "score_precision length must equal the score type's "
                    f"component count ({score_class.precision_len()})"
                )

        kernel = agent_builder.build_kernel(requester, score_precision)
        if logging_level not in (SolverLoggingLevels.Silent,
                                 SolverLoggingLevels.Warn):
            print(f"{agent_builder.metaheuristic_name} kernel path: "
                  f"{kernel.path}")
        runner = IslandRunner(
            kernel,
            n_islands=n_jobs,
            migration_frequency=agent_builder.migration_frequency,
            mesh=mesh,
            compare_to_global=getattr(agent_builder, "compare_to_global", True),
        )
        own = runner.local_islands

        global_score_obj = None
        solution_json = None
        if resume_from is not None:
            resumed = (resume_from if isinstance(resume_from, dict)
                       else load_checkpoint(resume_from))
            state = runner.local_state(
                from_numpy_tree(resumed["state"], device))
            if len(resumed["generators"]) != n_jobs:
                raise ValueError(
                    f"the checkpoint holds {len(resumed['generators'])} "
                    f"islands, the solve {n_jobs}")
            generators = island_generators(0, n_jobs, device)[own]
            for g, g_state in zip(generators, resumed["generators"][own],
                                  strict=True):
                g.set_state(torch.from_numpy(np.array(g_state)))
            strategies = resumed["strategies"]
            alive = np.asarray(resumed["alive"], dtype=bool).copy()
            chunk_id = resumed["chunk_id"]
            if resumed.get("best") is not None:
                best_row, solution_json = resumed["best"]
                global_score_obj = score_class.from_row(best_row)
        else:
            if seed is None:
                seed = np.random.SeedSequence().entropy % (2**63)
                if mesh is not None:
                    seed = mesh.broadcast(seed)  # the first rank's seed
            generators = island_generators(seed, n_jobs, device)[own]
            state = runner.init(generators)
            strategies = [agent_builder.termination_strategy.clone()
                          for _ in range(n_jobs)]
            alive = np.ones(n_jobs, dtype=bool)
            chunk_id = 0
        vm = requester.variables_manager
        solving_start = time.time()
        is_sa_auto = (
            getattr(agent_builder, "cooling_rate", object()) is None
            and agent_builder.metaheuristic_name == "SimulatedAnnealing"
        )

        def save(final=False):
            if checkpoint_path is None:
                return
            if not final and chunk_id % max(1, checkpoint_frequency) != 0:
                return
            whole, gen_states = runner.gather_state(state, generators)
            if not lead:
                return
            best = (None if global_score_obj is None
                    else (np.asarray(global_score_obj.values), solution_json))
            save_checkpoint(checkpoint_path, state=whole,
                            generator_states=gen_states,
                            strategies=strategies, alive=alive,
                            chunk_id=chunk_id, best=best,
                            meta={"n_jobs": n_jobs, "seed": seed})

        profiler = ProfileCapture(profile_dir if lead else None, device)
        if metrics is not None:
            metrics.start()
        moves_per_step = (kernel.moves_per_step
                          or getattr(agent_builder, "neighbours_count", None)
                          or kernel.population_size)

        while True:
            # fixed chunk size; per-island step budgets keep StepsLimit exact
            steps = runner.migration_frequency
            budgets = np.full(n_jobs, steps, dtype=np.int32)
            for i, (strat, a) in enumerate(zip(strategies, alive)):
                if a and isinstance(strat, StepsLimit):
                    remaining = strat.steps_limit + 1 - strat.steps_made
                    budgets[i] = max(1, min(steps, remaining))

            extras = {}
            if is_sa_auto:
                # per-step auto-temperature: the runner lerps start..end
                # across the chunk (`agent_base.rs:537-552`; exact for
                # StepsLimit, chunk-granular for time-based strategies)
                extras["inverted_accomplish_rate"] = torch.tensor(
                    [1.0 - s.get_accomplish_rate() for s in strategies],
                    dtype=torch.float64, device=device)
                extras["inverted_accomplish_rate_end"] = torch.tensor(
                    [1.0 - s.predict_accomplish_rate(int(b))
                     for s, b in zip(strategies, budgets)],
                    dtype=torch.float64, device=device)

            profiler.tick(chunk_id)
            chunk_moves = int(np.sum(budgets[alive])) * moves_per_step
            if metrics is not None:
                _sync(device)
            t_chunk = time.time()
            state = runner.run_chunk(
                state, generators, torch.as_tensor(alive, device=device),
                extras, steps,
                steps_left=torch.as_tensor(budgets, device=device))
            if metrics is not None:
                _sync(device)
            chunk_ms = (time.time() - t_chunk) * 1e3

            # --- host sync: termination, logging, observers ----------------
            islands_state = state["islands"]
            if mesh is not None:
                # every island's top and sweep counters, in global order
                islands_state = runner.gather_islands(
                    islands_state, [k for k in ("top_score", "sweep_scored",
                                                "sweep_nonconv")
                                    if k in islands_state])
            top_scores = islands_state["top_score"].cpu().numpy()
            g_score = state["global_score"].cpu().numpy()
            top_objs = [score_class.from_row(row) for row in top_scores]
            for i, strat in enumerate(strategies):
                if alive[i]:
                    strat.update(top_objs[i], steps=int(budgets[i]))
                    if strat.is_accomplish():
                        alive[i] = False
                        if logging_level not in (SolverLoggingLevels.Silent,):
                            print(
                                f"Agent {i} has successfully terminated work. "
                                "Now it's just relaying migrants until all "
                                "agents are done."
                            )

            new_global = score_class.from_row(g_score)
            improved = global_score_obj is None or new_global < global_score_obj
            if improved:
                global_score_obj = new_global
                solution_json = _convert_to_json(
                    vm, state["global_values"].cpu().numpy(), new_global)
                if observers:
                    for obs in observers:
                        obs.update(solution_json)

            if metrics is not None and lead:
                record = {
                    "chunk": chunk_id,
                    "steps": steps,
                    "wall_ms": round(chunk_ms, 3),
                    "moves": chunk_moves,
                    "moves_per_s": round(chunk_moves / (chunk_ms / 1e3), 1)
                    if chunk_ms > 0 else 0.0,
                    "global_best": g_score.tolist(),
                    "improved": bool(improved),
                    "n_alive": int(np.sum(alive)),
                    "migrations": int(np.sum(alive)),
                    "kernel_path": kernel.path,
                }
                # sweep-health counters: cumulative scored candidates and
                # lateness-bound (non-converged) candidates
                if "sweep_scored" in islands_state:
                    record["sweep_scored"] = int(
                        islands_state["sweep_scored"].sum().item())
                    record["sweep_nonconv"] = int(
                        islands_state["sweep_nonconv"].sum().item())
                metrics.add(record, observers=observers)

            _log(logging_level, chunk_id, steps, new_global, improved,
                 solving_start, int(np.sum(alive)))
            chunk_id += 1
            save(final=not alive.any())
            if not alive.any():
                break
        profiler.close(chunk_id - 1)

        if solution_json is None:
            solution_json = _convert_to_json(
                vm, state["global_values"].cpu().numpy(),
                score_class.from_row(state["global_score"].cpu().numpy()))
        return solution_json


def _log(level, chunk_id, steps, global_score, improved, solving_start, n_alive):
    if level in (SolverLoggingLevels.Silent, SolverLoggingLevels.Warn):
        return
    if level == SolverLoggingLevels.FreshOnly and not improved:
        return
    now = datetime.datetime.now().strftime("%Y-%m-%d %H:%M:%S")
    elapsed = time.time() - solving_start
    msg = (
        f"{now}, Chunk: {chunk_id:6}, Steps/chunk: {steps:4}, "
        f"Global best score: {global_score}, Alive agents: {n_alive}, "
        f"Solving time: {elapsed:.3f}"
    )
    print(msg)
