"""TabuSearch — local search over batched neighbourhoods (counterpart of
`greyjack_tpu/agents/tabu_search.py`; reference `tabu_search.rs:16-77`,
`tabu_search_base.rs:25-199`): sample `neighbours_count` moves off the
current solution, accept the best neighbour iff it is no worse.

Ported: the int-delta branch — neighbours are scored as i32 delta rows
against a ctx carried in state (the fused delta kernel), the winner is
applied to the chromosome and the ctx, and the f64 score is materialized
from the ctx's exact sums. The sweep branch (ROADMAP Queue 1 items 1-2),
the f64 delta branch (item 3) and the plain branch (item 6) raise
NotImplementedError.
"""

from __future__ import annotations

import torch

from greyjack_tpu_torch.agents import base
from greyjack_tpu_torch.ops import lexico, moves


class TabuSearch:
    metaheuristic_kind = "LocalSearch"
    metaheuristic_name = "TabuSearch"

    def __init__(self, neighbours_count, tabu_entity_rate, compare_to_global,
                 mutation_rate_multiplier, move_probas, migration_frequency,
                 termination_strategy, sweep=False, sweep_targets=None,
                 sweep_window=None, sweep_stall_limit=32):
        self.neighbours_count = int(neighbours_count)
        self.tabu_entity_rate = float(tabu_entity_rate)
        self.compare_to_global = bool(compare_to_global)
        self.mutation_rate_multiplier = mutation_rate_multiplier
        self.move_probas = move_probas
        self.migration_frequency = int(migration_frequency)
        self.termination_strategy = termination_strategy
        self.sweep = bool(sweep)
        self.sweep_targets = sweep_targets
        self.sweep_window = sweep_window
        self.sweep_stall_limit = int(sweep_stall_limit)
        # local-search agents force population 1 / migration_rate 1.0
        # (`tabu_search.rs:68-71`)
        self.population_size = 1
        self.migration_rate = 1.0

    def build_kernel(self, requester, score_precision=None):
        vm = requester.variables_manager
        cfg = moves.MoverConfig(vm, self.tabu_entity_rate,
                                self.mutation_rate_multiplier, self.move_probas)
        score_fn = base.make_score_fn(requester, score_precision)
        n = self.neighbours_count

        if self.sweep:
            raise NotImplementedError(
                "TabuSearch sweep mode is not ported yet (ROADMAP Queue 1 "
                "items 1-2, VRP sweep)")
        if not requester.supports_delta:
            raise NotImplementedError(
                "plain-score TabuSearch is not ported yet (ROADMAP Queue 1 "
                "item 6)")
        precision_ok = base.fast_paths_ok(requester, score_precision)
        calc = requester.cotwin.score_calculator
        has_ints = (precision_ok
                    and calc.delta_score_batch_ints_fn is not None
                    and calc.delta_ctx_score_fn is not None)
        if not has_ints:
            raise NotImplementedError(
                "only the int-delta TabuSearch path is ported; the f64 "
                "delta path waits for `score_delta` (ROADMAP Queue 1 "
                "item 3)")
        ints_to_row = (base.make_rounded_ints_to_row_fn(
            requester, score_precision)
            if score_precision is not None else None)

        def init_state(generators):
            population = torch.stack(
                [vm.sample_variables(g, 1) for g in generators])  # [I, 1, V]
            n_isl, _, v = population.shape
            scores = score_fn(population.reshape(n_isl, v)).reshape(
                n_isl, 1, -1)
            state = base.base_state(population, scores)
            state["tabu"] = cfg.init_tabu_state(n_isl)
            state["ctx"] = requester.build_base_ctx(population[:, 0])
            return state

        def step(generators, state, extras):
            # self-gating: for an island with `_active` False every write
            # below is an exact identity (the winner is invalidated, the
            # tabu push count drops to 0, step_id freezes)
            n_isl = state["population"].shape[0]
            active = extras.get("_active")
            if active is None:
                active = torch.ones(n_isl, dtype=torch.bool,
                                    device=vm.device)
            base_row = state["population"][:, 0]
            deltas, info = moves.move_population_delta(
                generators, base_row, n, vm, cfg, state["tabu"],
                extras.get("_free"))
            ints = requester.request_score_delta_ints(state["ctx"], deltas)
            if ints is None:
                raise NotImplementedError(
                    "this move set is outside the fused delta kernel's "
                    "eligibility and the f64 delta path is not ported yet")
            state = dict(state)
            best = lexico.lex_argmin(ints)                     # [I]
            best_delta = moves.take_one(ints, best)            # [I, S]
            if ints_to_row is None:
                accept = lexico.lex_leq(
                    best_delta, torch.zeros_like(best_delta)) & active
                cand_row = None
            else:
                cand_row = ints_to_row(requester.ctx_int_totals(state["ctx"])
                                       + best_delta.to(torch.int64))
                accept = lexico.lex_leq(cand_row,
                                        state["scores"][:, 0]) & active
            winner = moves.take_one(deltas, best)
            winner = {**winner, "valid": winner["valid"] & accept[:, None]}
            state["population"] = moves.apply_delta(base_row, winner)[:, None]
            state["ctx"] = requester.update_ctx(state["ctx"], winner)
            # guarded: a rejected / inactive step keeps the stored score
            new_score = (cand_row if cand_row is not None
                         else requester.ctx_score_row(state["ctx"]))
            state["scores"] = torch.where(accept[:, None, None],
                                          new_score[:, None, :],
                                          state["scores"])
            if cfg.use_tabu:
                state["tabu"] = moves.update_tabu_from_info(
                    state["tabu"], info, best, active)
            state = base.update_top(state)
            state["step_id"] = state["step_id"] + active.to(
                state["step_id"].dtype)
            return state

        def refresh(state):
            state = dict(state)
            state["ctx"] = requester.build_base_ctx(state["population"][:, 0])
            return state

        def prestep(state):
            return {"_free": cfg.tabu_free(state["tabu"])}

        return base.MetaheuristicKernel(
            self, init_state, step, refresh, prestep=prestep, path="int-delta", moves_per_step=n)
