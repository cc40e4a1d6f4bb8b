"""TabuSearch — local search over batched neighbourhoods (counterpart of
`greyjack_tpu/agents/tabu_search.py`; reference `tabu_search.rs:16-77`,
`tabu_search_base.rs:25-199`): sample `neighbours_count` moves off the
current solution, accept the best neighbour iff it is no worse.

Its own here: the no-worse rule, and the sweep form's stall escape (the
`sweep_stall` state). The step itself — the scoring path chosen once, the
proposal of each form, the winner commit and the step tail — is
`base.LocalSearch`'s; TabuSearch ranks a whole neighbourhood
(`ranks_neighbourhood`).
"""

from __future__ import annotations

import torch

from greyjack_tpu_torch.agents import base
from greyjack_tpu_torch.ops import lexico


class TabuSearch(base.LocalSearch):
    metaheuristic_name = "TabuSearch"
    ranks_neighbourhood = True

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

    @property
    def neighbours(self):
        return self.neighbours_count

    def init_rule(self, state, path):
        if path == "sweep":
            state["sweep_stall"] = torch.zeros_like(state["step_id"])
        return state

    def accept(self, state, p):
        """The best neighbour iff no worse (`tabu_search_base.rs:139-155`);
        in the sweep form, also once the island has stalled."""
        if p["cand"] is None:
            # unrounded exact rows: no worse is a delta <= 0
            improves = lexico.lex_leq(p["exact"], torch.zeros_like(p["exact"]))
        else:
            improves = lexico.lex_leq(p["cand"], state["scores"][:, 0])
        if p["path"] != "sweep":
            return improves
        return improves | (state["sweep_stall"] >= self.sweep_stall_limit)

    def accepted(self, state, p, accept, new_score):
        if p["path"] != "sweep":
            return
        new_best = lexico.lex_less(new_score, state["top_score"]) & accept
        stall = state["sweep_stall"]
        state["sweep_stall"] = torch.where(
            p["active"], torch.where(new_best, 0, stall + 1), stall)
