"""Solver — the orchestration entry point (counterpart of
`greyjack_tpu/solver/solver.py`; reference `solver.rs:25-149`).

`Solver.solve` builds the domain, compiles the cotwin onto the device of the
domain's distance matrix, builds the metaheuristic's kernel, runs `n_jobs`
islands as one batch on that device, and loops over chunks of
`migration_frequency` steps with host syncs for termination, logging,
observers and metrics, until every island has terminated. Each island draws
from its own `torch.Generator`, seeded from `seed`.

Not ported yet: `mesh`, `checkpoint_path` / `resume_from` and `profile_dir`
(setting any of them raises).
"""

from __future__ import annotations

import datetime
import time

import numpy as np
import torch

from greyjack_tpu_torch.parallel.islands import IslandRunner
from greyjack_tpu_torch.score_calculation.score_requesters import ScoreRequester
from greyjack_tpu_torch.solver.solver_logging_levels import SolverLoggingLevels
from greyjack_tpu_torch.agents.termination_strategies.strategies import (
    StepsLimit,
)


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
        """metrics: a `solver.metrics.SolverMetrics` collector, filled with
        one record per chunk (wall ms after the device finished, moves/s,
        best score, kernel path) and fanned out to observers implementing
        `update_metrics`."""
        for name, value in (("mesh", mesh), ("checkpoint_path", checkpoint_path),
                            ("resume_from", resume_from),
                            ("profile_dir", profile_dir)):
            if value is not None:
                raise NotImplementedError(
                    f"Solver.solve({name}=...) is not ported yet")

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
            compare_to_global=getattr(agent_builder, "compare_to_global", True),
        )

        if seed is None:
            seed = np.random.SeedSequence().entropy % (2**63)
        generators = island_generators(seed, n_jobs, device)
        state = runner.init(generators)
        strategies = [agent_builder.termination_strategy.clone()
                      for _ in range(n_jobs)]
        alive = np.ones(n_jobs, dtype=bool)
        chunk_id = 0
        vm = requester.variables_manager
        solving_start = time.time()

        if metrics is not None:
            metrics.start()
        moves_per_step = (kernel.moves_per_step
                          or getattr(agent_builder, "neighbours_count", None)
                          or kernel.population_size)

        global_score_obj = None
        solution_json = None
        while True:
            # fixed chunk size; per-island step budgets keep StepsLimit exact
            steps = runner.migration_frequency
            budgets = np.full(n_jobs, steps, dtype=np.int32)
            for i, (strat, a) in enumerate(zip(strategies, alive)):
                if a and isinstance(strat, StepsLimit):
                    remaining = strat.steps_limit + 1 - strat.steps_made
                    budgets[i] = max(1, min(steps, remaining))

            chunk_moves = int(np.sum(budgets[alive])) * moves_per_step
            if metrics is not None:
                _sync(device)
            t_chunk = time.time()
            state = runner.run_chunk(
                state, generators, torch.as_tensor(alive, device=device), {},
                steps, steps_left=torch.as_tensor(budgets, device=device))
            if metrics is not None:
                _sync(device)
            chunk_ms = (time.time() - t_chunk) * 1e3

            # --- host sync: termination, logging, observers ----------------
            top_scores = state["islands"]["top_score"].cpu().numpy()
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

            if metrics is not None:
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
                metrics.add(record, observers=observers)

            _log(logging_level, chunk_id, steps, new_global, improved,
                 solving_start, int(np.sum(alive)))
            chunk_id += 1
            if not alive.any():
                break

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
