"""SimulatedAnnealing — per-score-component temperatures (counterpart of
`greyjack_tpu/agents/simulated_annealing.py`; reference
`simulated_annealing.rs:15-79`, `simulated_annealing_base.rs:29-244`):
geometric cooling with a 1e-7 floor, or, when `cooling_rate` is None,
temperature = 1 - accomplish rate, injected before every step by the
runner (`agent_base.rs:537-552`). Metropolis acceptance uses the product
over components of exp(-delta_i / T_i) against one f64 uniform per island,
drawn from that island's generator after the proposal's draws
(`accept_uniforms`).

Its own here: the temperatures and the Metropolis rule, with the sweep
form's cooling (clamped, on active steps only) apart from the other
forms' (`next_temperature`), as the JAX package has them. The step — one
candidate a step, the sweep winner or one random move scored against the
ctx or by a full rescore — is `base.LocalSearch`'s.
"""

from __future__ import annotations

import torch

from greyjack_tpu_torch.agents import base
from greyjack_tpu_torch.ops import lexico, moves


def accept_uniforms(generators, device):
    """f64[I]: one uniform in [0, 1) per island from its generator."""
    return moves.island_draws(generators, torch.rand, (),
                              dtype=torch.float64, device=device)


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


class SimulatedAnnealing(base.LocalSearch):
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
        if len(self.initial_temperature) != requester.score_size:
            raise ValueError(
                "initial_temperature length must equal score component count"
            )
        return super().build_kernel(requester, score_precision)

    def init_rule(self, state, path):
        scores = state["scores"]
        state["temperature"] = torch.tensor(
            self.initial_temperature, dtype=torch.float64,
            device=scores.device).expand(scores.shape[0], -1).clone()
        return state

    def accept(self, state, p):
        """No worse, or with the Metropolis probability at the cooled (or
        auto) temperature (`simulated_annealing_base.rs:167-183`)."""
        cand, current = p["cand"], state["scores"][:, 0]
        cooling = self.cooling_rate
        if p["path"] == "sweep":
            cooled = (torch.clamp(state["temperature"] * cooling, min=1e-7)
                      if cooling is not None
                      else p["extras"]["inverted_accomplish_rate"][:, None])
            temp = torch.where(p["active"][:, None], cooled,
                               state["temperature"])
        else:
            temp = next_temperature(state, cooling, p["extras"], cand)
        state["temperature"] = temp
        proba = accept_proba(cand, current, temp)
        u = accept_uniforms(p["generators"], cand.device)
        return lexico.lex_leq(cand, current) | (u < proba)
