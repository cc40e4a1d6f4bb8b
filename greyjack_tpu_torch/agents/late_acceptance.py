"""LateAcceptance — Burke–Bykov late acceptance hill climbing (counterpart
of `greyjack_tpu/agents/late_acceptance.py`; reference
`late_acceptance.rs:16-75`, `late_acceptance_base.rs:29-253`): keep the
last `late_acceptance_size` accepted scores; accept a candidate iff its
score is no worse than the oldest of them OR than the current score.

Its own here: that rule and its deque, a fixed-size ring per island
(`buf` f64[I, size, S] with `count` and `head`, the next write slot,
i32[I]). The step — one candidate a step, the sweep winner or one random
move scored against the ctx or by a full rescore — is
`base.LocalSearch`'s.
"""

from __future__ import annotations

import torch

from greyjack_tpu_torch.agents import base
from greyjack_tpu_torch.ops import lexico


def ring_init(n_islands, size, score_size, device):
    return {
        "buf": torch.zeros((n_islands, size, score_size),
                           dtype=torch.float64, device=device),
        "count": torch.zeros(n_islands, dtype=torch.int32, device=device),
        "head": torch.zeros(n_islands, dtype=torch.int32, device=device),
    }


def ring_oldest(ring, fallback):
    """VecDeque.back() per island: the oldest retained score f64[I, S];
    `fallback` [I, S] where the ring is empty. The slot is a floor-mod."""
    size = ring["buf"].shape[1]
    idx = torch.remainder(ring["head"] - ring["count"], size)
    ar = torch.arange(idx.shape[0], device=idx.device)
    value = ring["buf"][ar, idx.long()]
    return torch.where((ring["count"] > 0)[:, None], value, fallback)


def ring_push_front(ring, score, enable):
    """push_front + bounded pop_back (`late_acceptance_base.rs:172-180`) of
    score f64[I, S]; a no-op for islands whose `enable` (bool[I]) is
    False."""
    size = ring["buf"].shape[1]
    slot = torch.arange(size, device=score.device) == ring["head"][:, None]
    write = (slot & enable[:, None])[..., None]
    buf = torch.where(write, score[:, None, :], ring["buf"])
    head = torch.where(enable, torch.remainder(ring["head"] + 1, size),
                       ring["head"])
    count = torch.where(enable, torch.clamp(ring["count"] + 1, max=size),
                        ring["count"])
    return {"buf": buf, "count": count, "head": head}


def late_accept(cand, current, ring):
    """bool[I]: candidate rows no worse than the ring's oldest entry or
    than the current score (`late_acceptance_base.rs:143-186`)."""
    oldest = ring_oldest(ring, current)
    return lexico.lex_leq(cand, oldest) | lexico.lex_leq(cand, current)


class LateAcceptance(base.LocalSearch):
    metaheuristic_name = "LateAcceptance"

    def __init__(self, late_acceptance_size, tabu_entity_rate,
                 mutation_rate_multiplier, move_probas, migration_frequency,
                 termination_strategy, sweep=False, sweep_targets=None,
                 sweep_window=None):
        self.late_acceptance_size = int(late_acceptance_size)
        self.tabu_entity_rate = float(tabu_entity_rate)
        self.mutation_rate_multiplier = mutation_rate_multiplier
        self.move_probas = move_probas
        self.migration_frequency = int(migration_frequency)
        self.termination_strategy = termination_strategy
        # sweep-neighbourhood mode (see TabuSearch): the per-step candidate
        # is the sweep winner instead of one random move, under the same
        # late-acceptance rule; LA has no stall escape
        self.sweep = bool(sweep)
        self.sweep_targets = sweep_targets
        self.sweep_window = sweep_window
        self.population_size = 1
        self.migration_rate = 1.0

    def init_rule(self, state, path):
        scores = state["scores"]
        state["late"] = ring_init(scores.shape[0], self.late_acceptance_size,
                                  scores.shape[-1], scores.device)
        return state

    def accept(self, state, p):
        return late_accept(p["cand"], state["scores"][:, 0], state["late"])

    def accepted(self, state, p, accept, new_score):
        state["late"] = ring_push_front(state["late"], p["cand"], accept)
