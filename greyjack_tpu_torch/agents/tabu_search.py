"""TabuSearch — local search over batched neighbourhoods (counterpart of
`greyjack_tpu/agents/tabu_search.py`; reference `tabu_search.rs:16-77`,
`tabu_search_base.rs:25-199`): sample `neighbours_count` moves off the
current solution, accept the best neighbour iff it is no worse.

Ported: the sweep branch — every candidate value of T sampled target
stops is scored from ctx cumulants (`models/vrp/sweep.py`), the winner is
re-scored exactly and accepted iff no worse — and the delta branch —
neighbours are scored against a ctx carried in state, as i32 delta rows
(the fused delta kernel) where the model and shape allow, else as f64
score rows (`ScoreRequester.request_score_delta`). Each applies the winner
to the chromosome and the ctx — and the plain branch, for cotwins without
delta kernels: `neighbours_count` copies of the current solution each take
one move of the generic sampler (`ops/moves.py` `move_population`), are
fixed and scored by one full rescore, and the best is accepted iff no
worse.
"""

from __future__ import annotations

import torch

from greyjack_tpu_torch.agents import base
from greyjack_tpu_torch.ops import lexico, moves
from greyjack_tpu_torch.utils.tracing import span


def plain_accept_best(pm, state, moved, scores, info):
    """The deterministic rest of a plain TabuSearch step: each island's
    lexicographically best neighbour (lowest index on ties) replaces the
    current solution iff no worse."""
    with span("gj.agent.accept"):
        best = lexico.lex_argmin(scores)                             # [I]
        best_row = moves.take_one(scores, best)
        accept = lexico.lex_leq(best_row, state["scores"][:, 0])
        best_moved = moves.take_one(moved, best)[:, None]
    return pm.accept(state, best_moved, best_row[:, None], accept, info,
                     best)


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
            return self._build_plain_kernel(requester, cfg, score_precision)
        delta_score_fn = base.make_delta_score_fn(requester, score_precision)
        # accept-boundary rounding keeps the int path live under
        # score_precision (None when unrounded: exact delta <= 0 compare)
        ints_to_row = (base.make_rounded_ints_to_row_fn(
            requester, score_precision)
            if score_precision is not None and precision_ok else None)
        init_state, refresh, prestep = base.ctx_state_fns(requester, cfg,
                                                          score_fn)
        use_ints = (precision_ok
                    and requester.delta_ints_eligible(cfg.delta_width))

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
            # int-delta rows where the model and the kernel serve this
            # width (`use_ints`, a host-side static): rank / accept on
            # exact i32 deltas and materialize the f64 score from the ctx
            # sums; else f64 rows
            if use_ints:
                rows = requester.request_score_delta_ints(state["ctx"],
                                                          deltas)
            else:
                rows = delta_score_fn(state["ctx"], deltas)    # [I, P, S]
            with span("gj.agent.accept"):
                best = lexico.lex_argmin(rows)                 # [I]
                if use_ints:
                    best_delta = moves.take_one(rows, best)    # [I, S]
                    if ints_to_row is None:
                        cand_row = None
                        improves = lexico.lex_leq(
                            best_delta, torch.zeros_like(best_delta))
                    else:
                        cand_row = ints_to_row(
                            requester.ctx_int_totals(state["ctx"])
                            + best_delta.to(torch.int64))
                        improves = lexico.lex_leq(cand_row,
                                                  state["scores"][:, 0])
                else:
                    cand_row = moves.take_one(rows, best)
                    improves = lexico.lex_leq(cand_row, state["scores"][:, 0])
                accept = improves & active
                winner = moves.take_one(deltas, best)
                winner = {**winner,
                          "valid": winner["valid"] & accept[:, None]}
                state = dict(state)
                with span("gj.agent.apply"):
                    state["population"] = moves.apply_delta(
                        base_row, winner)[:, None]
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

        # the label is the JAX package's (`tabu_search.py:181-191`):
        # "int-delta" whenever the model registers the integer rows and
        # precision allows, even where the step's i32 route turns this
        # width or instance down (kd 16, i64 bounds) and scores f64 rows.
        # The free lists feed the narrow sampler only
        has_ints = (precision_ok
                    and requester.registers_delta_ints)
        return base.MetaheuristicKernel(
            self, init_state, step, refresh, self_gating=True,
            prestep=prestep if cfg.narrow else None,
            path="int-delta" if has_ints else "delta", moves_per_step=n)

    def _build_plain_kernel(self, requester, cfg, score_precision=None):
        """Full-rescore local search (`greyjack_tpu/agents/tabu_search.py:
        194-223`): the neighbourhood is `neighbours_count` moved copies of
        the current solution; the lexicographically best is accepted iff
        no worse, and its touched slots enter the tabu rings."""
        n = self.neighbours_count
        pm = base.PlainMoveStep(requester, cfg, score_precision)
        init_state = base.plain_init_state(requester, cfg, pm.pop_score_fn, 1)

        def step(generators, state, extras):
            current = state["population"][:, 0]                    # [I, V]
            neighbours = current[:, None].expand(current.shape[0], n,
                                                 current.shape[1])
            moved, info, scores = pm.propose(generators, state, neighbours)
            return plain_accept_best(pm, state, moved, scores, info)

        return base.MetaheuristicKernel(self, init_state, step, path="plain",
                                        moves_per_step=n)

    def _build_sweep_kernel(self, requester, cfg, score_fn,
                            score_precision=None):
        """Sweep-neighbourhood local search: dense value sweeps scored from
        ctx cumulants, the winner re-scored exactly and accepted iff no
        worse than the current solution — the reference's
        accept-best-neighbour semantics (`tabu_search_base.rs:139-155`)
        over a larger, value-structured neighbourhood. The winner is a
        narrow delta, so apply / ctx update / tabu are the int-delta
        path's."""
        sw = base.SweepStep(self, requester, cfg, score_precision)
        stall_limit = self.sweep_stall_limit
        ctx_init_state, refresh, prestep = base.ctx_state_fns(
            requester, cfg, score_fn)

        def init_state(generators):
            state = sw.init_counters(ctx_init_state(generators))
            state["sweep_stall"] = torch.zeros_like(state["step_id"])
            return state

        def step(generators, state, extras):
            p = sw.propose(generators, state, extras)
            with span("gj.agent.accept"):
                active, exact = p["active"], p["exact"]
                forced = state["sweep_stall"] >= stall_limit
                if sw.ints_to_row is None:
                    cand_row = None
                    improves = lexico.lex_leq(exact, torch.zeros_like(exact))
                else:
                    cand_row = sw.cand_row(state, exact)
                    improves = lexico.lex_leq(cand_row, state["scores"][:, 0])
                accept = (improves | forced) & p["ok"]
                winner = {**p["delta"],
                          "valid": p["delta"]["valid"] & accept[:, None]}
                state = dict(state)
                with span("gj.agent.apply"):
                    state["population"] = moves.apply_delta(
                        state["population"][:, 0], winner)[:, None]
                state["ctx"] = requester.update_ctx(state["ctx"], winner)
                new_score = (cand_row if cand_row is not None
                             else requester.ctx_score_row(state["ctx"]))
                new_best = (lexico.lex_less(new_score, state["top_score"])
                            & accept)
                state["sweep_stall"] = torch.where(
                    active, torch.where(new_best, 0,
                                        state["sweep_stall"] + 1),
                    state["sweep_stall"])
                state["scores"] = torch.where(accept[:, None, None],
                                              new_score[:, None, :],
                                              state["scores"])
            return sw.finish(state, p)

        return base.MetaheuristicKernel(
            self, init_state, step, refresh, self_gating=True,
            prestep=prestep, path="sweep", moves_per_step=sw.moves_per_step)
