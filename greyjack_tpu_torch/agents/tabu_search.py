"""TabuSearch — local search over batched neighbourhoods (counterpart of
`greyjack_tpu/agents/tabu_search.py`; reference `tabu_search.rs:16-77`,
`tabu_search_base.rs:25-199`): sample `neighbours_count` moves off the
current solution, accept the best neighbour iff it is no worse.

Ported: the sweep branch — every candidate value of T sampled target
stops is scored from ctx cumulants (`models/vrp/sweep.py`), the winner is
re-scored exactly and accepted iff no worse — and the int-delta branch —
neighbours are scored as i32 delta rows against a ctx carried in state
(the fused delta kernel). Both apply the winner to the chromosome and the
ctx and materialize the f64 score from the ctx's exact sums. The f64 delta
branch (ROADMAP Queue 1 item 3) and the plain branch (item 6) raise
NotImplementedError.
"""

from __future__ import annotations

import torch

from greyjack_tpu_torch.agents import base
from greyjack_tpu_torch.ops import lexico, moves, selection


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
        # sweep-neighbourhood mode: per step, every candidate value for
        # `sweep_targets` sampled stops is scored instead of
        # `neighbours_count` random moves; a RuntimeWarning is emitted when
        # the sweep cannot engage, and the kernel records its `path`
        self.sweep = bool(sweep)
        self.sweep_targets = sweep_targets
        self.sweep_window = sweep_window
        # escape hatch: after `sweep_stall_limit` steps without a new best,
        # the best candidate is accepted even when worse (move to the best
        # non-tabu neighbour); hill-climb acceptance resumes on a new best
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

        precision_ok = base.fast_paths_ok(requester, score_precision)
        if self.sweep and requester.supports_sweep and precision_ok:
            return self._build_sweep_kernel(requester, cfg, score_fn,
                                            score_precision)
        if self.sweep:
            base.announce_fallback(self, requester, score_precision)
        if not requester.supports_delta:
            raise NotImplementedError(
                "plain-score TabuSearch is not ported yet (ROADMAP Queue 1 "
                "item 6)")
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
        init_state, refresh, prestep = _ctx_state_fns(requester, cfg,
                                                      score_fn)

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

        return base.MetaheuristicKernel(
            self, init_state, step, refresh, prestep=prestep, path="int-delta", moves_per_step=n)

    def _build_sweep_kernel(self, requester, cfg, score_fn,
                            score_precision=None):
        """Sweep-neighbourhood local search: dense value sweeps scored from
        ctx cumulants, the winner re-scored exactly and accepted iff no
        worse than the current solution — the reference's
        accept-best-neighbour semantics (`tabu_search_base.rs:139-155`)
        over a larger, value-structured neighbourhood. The winner is a
        narrow delta, so apply / ctx update / tabu are the int-delta
        path's."""
        vm = requester.variables_manager
        mod = requester.sweep_module
        sweep_cfg = mod.SweepConfig(requester, self.sweep_targets,
                                    self.sweep_window)
        utils = requester._delta_utils()
        # accept-boundary rounding (None when unrounded): candidate row =
        # rounded((ctx_ints + exact) / scales), compared lexicographically
        # against the rounded incumbent
        ints_to_row = (base.make_rounded_ints_to_row_fn(
            requester, score_precision)
            if score_precision is not None else None)
        stall_limit = self.sweep_stall_limit
        ctx_init_state, refresh, prestep = _ctx_state_fns(requester, cfg,
                                                          score_fn)

        def init_state(generators):
            state = ctx_init_state(generators)
            zeros = torch.zeros(len(generators), dtype=torch.int64,
                                device=vm.device)
            state["sweep_scored"] = zeros
            # candidates whose lateness was a bound, not exact
            state["sweep_nonconv"] = zeros
            state["sweep_stall"] = zeros.to(torch.int32)
            return state

        def step(generators, state, extras):
            # self-gating: for an island with `_active` False every write
            # below is an exact identity
            n_isl = state["population"].shape[0]
            active = extras.get("_active")
            if active is None:
                active = torch.ones(n_isl, dtype=torch.bool,
                                    device=vm.device)
            free = extras.get("_free")
            if free is None:
                free = cfg.tabu_free(state["tabu"])
            masks = cfg.tabu_masks(state["tabu"])
            delta, exact, info, stats = mod.propose(
                generators, state["ctx"], free, masks, sweep_cfg, utils)
            stub = torch.iinfo(exact.dtype).max
            forced = state["sweep_stall"] >= stall_limit
            if ints_to_row is None:
                cand_row = None
                improves = lexico.lex_leq(exact, torch.zeros_like(exact))
            else:
                cand_row = ints_to_row(requester.ctx_int_totals(state["ctx"])
                                       + exact.to(torch.int64))
                improves = lexico.lex_leq(cand_row, state["scores"][:, 0])
            accept = (improves | forced) & active & (exact[:, 0] != stub)
            winner = {**delta, "valid": delta["valid"] & accept[:, None]}
            base_row = state["population"][:, 0]
            state = dict(state)
            state["population"] = moves.apply_delta(base_row, winner)[:, None]
            state["ctx"] = requester.update_ctx(state["ctx"], winner)
            new_score = (cand_row if cand_row is not None
                         else requester.ctx_score_row(state["ctx"]))
            new_best = lexico.lex_less(new_score, state["top_score"]) & accept
            state["sweep_stall"] = torch.where(
                active, torch.where(new_best, 0, state["sweep_stall"] + 1),
                state["sweep_stall"])
            state["scores"] = torch.where(accept[:, None, None],
                                          new_score[:, None, :],
                                          state["scores"])
            if cfg.use_tabu:
                # the reference pushes touched ids during sampling
                # (`mover.rs:75-96`): push the winner's targets whether or
                # not accepted, rotating sweep targets out of tabu
                state["tabu"] = selection.tabu_push(
                    state["tabu"], info["group"], info["positions"],
                    torch.where(active, info["count"], 0))
            state["sweep_scored"] = state["sweep_scored"] + torch.where(
                active, stats["n_scored"], 0)
            state["sweep_nonconv"] = state["sweep_nonconv"] + torch.where(
                active, stats["n_nonconv"], 0)
            state = base.update_top(state)
            state["step_id"] = state["step_id"] + active.to(
                state["step_id"].dtype)
            return state

        return base.MetaheuristicKernel(
            self, init_state, step, refresh, prestep=prestep, path="sweep",
            moves_per_step=sweep_cfg.conservative_moves_per_step(
                utils, self.tabu_entity_rate))


def _ctx_state_fns(requester, cfg, score_fn):
    """(init_state, refresh, prestep) of the kernels that carry a delta ctx
    per island: the initial population, scores, tabu rings and ctx; the
    per-chunk ctx rebuild after migration; the per-step tabu free lists."""
    vm = requester.variables_manager

    def init_state(generators):
        population = torch.stack(
            [vm.sample_variables(g, 1) for g in generators])      # [I, 1, V]
        n_isl, _, v = population.shape
        scores = score_fn(population.reshape(n_isl, v)).reshape(n_isl, 1, -1)
        state = base.base_state(population, scores)
        state["tabu"] = cfg.init_tabu_state(n_isl)
        state["ctx"] = requester.build_base_ctx(population[:, 0])
        return state

    def refresh(state):
        state = dict(state)
        state["ctx"] = requester.build_base_ctx(state["population"][:, 0])
        return state

    def prestep(state):
        return {"_free": cfg.tabu_free(state["tabu"])}

    return init_state, refresh, prestep
