"""LateAcceptance — Burke–Bykov late acceptance hill climbing (counterpart
of `greyjack_tpu/agents/late_acceptance.py`; reference
`late_acceptance.rs:16-75`, `late_acceptance_base.rs:29-253`): keep the
last `late_acceptance_size` accepted scores; accept a candidate iff its
score is no worse than the oldest of them OR than the current score.

The deque is a fixed-size ring per island: `buf` f64[I, size, S] with
`count` and `head` (the next write slot) i32[I].

Three forms: the sweep form (the candidate is the sweep winner,
`models/vrp/sweep.py`), the delta form (one random move per step, scored
as an f64 row against the ctx in state) and, for cotwins without delta
kernels, the plain form (one move of the generic sampler, fixed and
scored by a full rescore).
"""

from __future__ import annotations

import torch

from greyjack_tpu_torch.agents import base
from greyjack_tpu_torch.ops import lexico, moves


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


def plain_accept(pm, state, moved, scores, info):
    """The deterministic rest of a plain LateAcceptance step: the moved
    candidate f[I, 1, V] with score rows f64[I, 1, S] replaces the current
    one where it is late-accepted, and its score enters the ring."""
    cand = scores[:, 0]
    accept = late_accept(cand, state["scores"][:, 0], state["late"])
    state = dict(state)
    state["late"] = ring_push_front(state["late"], cand, accept)
    return pm.accept(state, moved, scores, accept, info,
                     torch.zeros_like(accept, dtype=torch.int64))


class LateAcceptance:
    metaheuristic_kind = "LocalSearch"
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
        # late-acceptance rule
        self.sweep = bool(sweep)
        self.sweep_targets = sweep_targets
        self.sweep_window = sweep_window
        self.population_size = 1
        self.migration_rate = 1.0

    def build_kernel(self, requester, score_precision=None):
        vm = requester.variables_manager
        cfg = moves.MoverConfig(vm, self.tabu_entity_rate,
                                self.mutation_rate_multiplier, self.move_probas)
        score_fn = base.make_score_fn(requester, score_precision)
        s = requester.score_size
        size = self.late_acceptance_size

        precision_ok = base.fast_paths_ok(requester, score_precision)
        if self.sweep and requester.supports_sweep and precision_ok:
            return self._build_sweep_kernel(requester, cfg, score_fn, s,
                                            score_precision)
        if self.sweep:
            base.announce_fallback(self, requester, score_precision)
        if not requester.supports_delta:
            return self._build_plain_kernel(requester, cfg, s,
                                            score_precision)

        # delta form: one O(K) delta per step against the ctx in state
        # (`late_acceptance_base.rs:188-241` semantics)
        rm = base.RandomMoveStep(requester, cfg, score_precision)
        ctx_init_state, refresh, _ = base.ctx_state_fns(requester, cfg,
                                                        score_fn)

        def init_state(generators):
            state = ctx_init_state(generators)
            state["late"] = ring_init(len(generators), size, s, vm.device)
            return state

        def step(generators, state, extras):
            # not self-gating: the runner masks inactive islands
            winner, info, cand = rm.propose(generators, state)
            accept = late_accept(cand, state["scores"][:, 0], state["late"])
            state = base.apply_winner(requester, state, winner, accept, cand)
            state["late"] = ring_push_front(state["late"], cand, accept)
            return rm.finish(state, info)

        return base.MetaheuristicKernel(self, init_state, step, refresh,
                                        path="delta", moves_per_step=1)

    def _build_plain_kernel(self, requester, cfg, s, score_precision=None):
        """Full-rescore form (`greyjack_tpu/agents/late_acceptance.py:
        132-163`): the moved, fixed and rescored solution is accepted iff
        no worse than the ring's oldest entry or the current score."""
        vm = requester.variables_manager
        size = self.late_acceptance_size
        pm = base.PlainMoveStep(requester, cfg, score_precision)
        plain_init = base.plain_init_state(requester, cfg, pm.pop_score_fn, 1)

        def init_state(generators):
            state = plain_init(generators)
            state["late"] = ring_init(len(generators), size, s, vm.device)
            return state

        def step(generators, state, extras):
            moved, info, scores = pm.propose(generators, state,
                                             state["population"])
            return plain_accept(pm, state, moved, scores, info)

        return base.MetaheuristicKernel(self, init_state, step, path="plain",
                                        moves_per_step=1)

    def _build_sweep_kernel(self, requester, cfg, score_fn, s,
                            score_precision=None):
        """Late acceptance over sweep-winner proposals: the candidate each
        step is the best of the dense value sweeps, accepted iff no worse
        than the ring's oldest entry or the current score — the reference
        rule (`late_acceptance_base.rs:143-186`) over a stronger proposal
        distribution. LA has no stall escape."""
        vm = requester.variables_manager
        sw = base.SweepStep(self, requester, cfg, score_precision)
        size = self.late_acceptance_size
        ctx_init_state, refresh, prestep = base.ctx_state_fns(requester, cfg,
                                                              score_fn)

        def init_state(generators):
            state = sw.init_counters(ctx_init_state(generators))
            state["late"] = ring_init(len(generators), size, s, vm.device)
            return state

        def step(generators, state, extras):
            p = sw.propose(generators, state, extras)
            cand = sw.cand_row(state, p["exact"])
            accept = (late_accept(cand, state["scores"][:, 0], state["late"])
                      & p["ok"])
            state = base.apply_winner(requester, state, p["delta"], accept,
                                      cand)
            state["late"] = ring_push_front(state["late"], cand, accept)
            return sw.finish(state, p)

        return base.MetaheuristicKernel(
            self, init_state, step, refresh, self_gating=True,
            prestep=prestep, path="sweep", moves_per_step=sw.moves_per_step)
