"""SimulatedAnnealing — per-score-component temperatures (counterpart of
`greyjack_tpu/agents/simulated_annealing.py`; reference
`simulated_annealing.rs:15-79`, `simulated_annealing_base.rs:29-244`):
geometric cooling with a 1e-7 floor, or, when `cooling_rate` is None,
temperature = 1 - accomplish rate, injected before every step by the
runner (`agent_base.rs:537-552`). Metropolis acceptance uses the product
over components of exp(-delta_i / T_i) against one f64 uniform per island,
drawn from that island's generator (`accept_uniforms`).

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


def accept_uniforms(generators, device):
    """f64[I]: one uniform in [0, 1) per island from its generator."""
    return torch.stack([torch.rand((), generator=g, dtype=torch.float64,
                                   device=device) for g in generators])


def accept_proba(cand, current, temp):
    """f64[I]: prod over components of exp(-(cand - current) / T)."""
    return torch.prod(torch.exp(-((cand - current) / temp)), dim=-1)


def next_temperature(state, cooling, extras, like):
    """Geometric cooling with its 1e-7 floor (`:156-165`), or the auto
    temperature 1 - accomplish rate from the runner's extras."""
    if cooling is not None:
        temp = state["temperature"] * cooling
        return torch.where(temp < 1e-6, 1e-7, temp)
    return extras["inverted_accomplish_rate"][:, None].expand(like.shape)


def plain_accept(pm, state, moved, scores, info, u, cooling, extras):
    """The deterministic rest of a plain SimulatedAnnealing step, given the
    moved candidate f[I, 1, V], its rows f64[I, 1, S] and the accept
    uniforms u f64[I]."""
    cand = scores[:, 0]
    temp = next_temperature(state, cooling, extras, cand)
    current = state["scores"][:, 0]
    accept = (lexico.lex_leq(cand, current)
              | (u < accept_proba(cand, current, temp)))
    state = dict(state)
    state["temperature"] = temp
    return pm.accept(state, moved, scores, accept, info,
                     torch.zeros_like(accept, dtype=torch.int64))


class SimulatedAnnealing:
    metaheuristic_kind = "LocalSearch"
    metaheuristic_name = "SimulatedAnnealing"

    def __init__(self, initial_temperature, cooling_rate, tabu_entity_rate,
                 mutation_rate_multiplier, move_probas, migration_frequency,
                 termination_strategy, sweep=False, sweep_targets=None,
                 sweep_window=None):
        self.initial_temperature = [float(t) for t in initial_temperature]
        self.cooling_rate = cooling_rate
        self.tabu_entity_rate = float(tabu_entity_rate)
        self.mutation_rate_multiplier = mutation_rate_multiplier
        self.move_probas = move_probas
        self.migration_frequency = int(migration_frequency)
        self.termination_strategy = termination_strategy
        # sweep-neighbourhood mode (see TabuSearch): the per-step candidate
        # is the sweep winner, Metropolis-accepted under the same
        # per-component temperatures
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
        if len(self.initial_temperature) != s:
            raise ValueError(
                "initial_temperature length must equal score component count"
            )
        t0 = torch.tensor(self.initial_temperature, dtype=torch.float64,
                          device=vm.device)
        cooling = self.cooling_rate

        precision_ok = base.fast_paths_ok(requester, score_precision)
        if self.sweep and requester.supports_sweep and precision_ok:
            return self._build_sweep_kernel(requester, cfg, score_fn, s, t0,
                                            cooling, score_precision)
        if self.sweep:
            base.announce_fallback(self, requester, score_precision)
        if not requester.supports_delta:
            return self._build_plain_kernel(requester, cfg, s, t0, cooling,
                                            score_precision)

        # delta form: one O(K) delta per step against the ctx in state
        # (`simulated_annealing_base.rs:189-233` semantics)
        rm = base.RandomMoveStep(requester, cfg, score_precision)
        ctx_init_state, refresh, _ = base.ctx_state_fns(requester, cfg,
                                                        score_fn)

        def init_state(generators):
            state = ctx_init_state(generators)
            state["temperature"] = t0.expand(len(generators), s).clone()
            return state

        def step(generators, state, extras):
            # not self-gating: the runner masks inactive islands
            winner, info, cand = rm.propose(generators, state)
            temp = next_temperature(state, cooling, extras, cand)
            current = state["scores"][:, 0]
            proba = accept_proba(cand, current, temp)
            u = accept_uniforms(generators, vm.device)
            accept = lexico.lex_leq(cand, current) | (u < proba)
            state = base.apply_winner(requester, state, winner, accept, cand)
            state["temperature"] = temp
            return rm.finish(state, info)

        return base.MetaheuristicKernel(self, init_state, step, refresh,
                                        path="delta", moves_per_step=1)

    def _build_plain_kernel(self, requester, cfg, s, t0, cooling,
                            score_precision=None):
        """Full-rescore form (`greyjack_tpu/agents/simulated_annealing.py:
        123-162`): the moved, fixed and rescored solution is accepted iff
        no worse, or with the Metropolis probability at the cooled (or
        auto) temperature."""
        vm = requester.variables_manager
        pm = base.PlainMoveStep(requester, cfg, score_precision)
        plain_init = base.plain_init_state(requester, cfg, pm.pop_score_fn, 1)

        def init_state(generators):
            state = plain_init(generators)
            state["temperature"] = t0.expand(len(generators), s).clone()
            return state

        def step(generators, state, extras):
            moved, info, scores = pm.propose(generators, state,
                                             state["population"])
            u = accept_uniforms(generators, vm.device)
            return plain_accept(pm, state, moved, scores, info, u, cooling,
                                extras)

        return base.MetaheuristicKernel(self, init_state, step, path="plain",
                                        moves_per_step=1)

    def _build_sweep_kernel(self, requester, cfg, score_fn, s, t0, cooling,
                            score_precision=None):
        """Metropolis acceptance over sweep-winner proposals: the candidate
        is the best of the dense value sweeps; acceptance keeps the
        reference's product-of-exponentials rule
        (`simulated_annealing_base.rs:167-183`). The temperature only
        advances on active steps."""
        vm = requester.variables_manager
        sw = base.SweepStep(self, requester, cfg, score_precision)
        ctx_init_state, refresh, prestep = base.ctx_state_fns(requester, cfg,
                                                              score_fn)

        def init_state(generators):
            state = sw.init_counters(ctx_init_state(generators))
            state["temperature"] = t0.expand(len(generators), s).clone()
            return state

        def step(generators, state, extras):
            p = sw.propose(generators, state, extras)
            cand = sw.cand_row(state, p["exact"])
            if cooling is not None:
                new_temp = torch.clamp(state["temperature"] * cooling,
                                       min=1e-7)
            else:
                new_temp = extras["inverted_accomplish_rate"][:, None]
            temp = torch.where(p["active"][:, None], new_temp,
                               state["temperature"])
            current = state["scores"][:, 0]
            proba = accept_proba(cand, current, temp)
            u = accept_uniforms(generators, vm.device)
            accept = ((lexico.lex_leq(cand, current) | (u < proba))
                      & p["ok"])
            state = base.apply_winner(requester, state, p["delta"], accept,
                                      cand)
            state["temperature"] = temp
            return sw.finish(state, p)

        return base.MetaheuristicKernel(
            self, init_state, step, refresh, self_gating=True,
            prestep=prestep, path="sweep", moves_per_step=sw.moves_per_step)
