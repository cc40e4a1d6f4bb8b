"""GeneticAlgorithm — population metaheuristic with p-best parent selection
(counterpart of `greyjack_tpu/agents/genetic_algorithm.py`; reference
`genetic_algorithm.rs:16-84`, `genetic_algorithm_base.rs:23-235`).

Each island keeps a population f[I, P, V] sorted best first. A step picks
⌈P/2⌉ pairs of parents uniformly from the top ⌈U(1e-6, p_best_rate)·P⌉,
crosses each pair with one shared weight w (discrete genes inherit whole:
rint(w), exact halves up, as the reference's `rint`), gives every child
one move of the generic sampler, fixes and rescores the first P children,
pits each against a random p-worst native (the candidate wins when no
worse) and re-sorts. All islands and children are one batch.

The step is a draw (`draw`, from each island's generator) and a
deterministic body (`GeneticAlgorithm.build_kernel(...).body`) that gives
the JAX step's state bit for bit when fed the same leaves.
"""

from __future__ import annotations

import torch

from greyjack_tpu_torch.agents import base
from greyjack_tpu_torch.ops import lexico, moves
from greyjack_tpu_torch.utils.math_utils import rint_t


def p_best_ids(proba, u, p):
    """int32 row ids in [0, ⌈proba·p⌉): `select_p_best`
    (`genetic_algorithm_base.rs:83-92`) from its two f64 uniforms."""
    last_top = torch.ceil(proba * p).to(torch.int32)
    return torch.floor(u * last_top).to(torch.int32)


def p_worst_ids(proba, u, p):
    """int32 row ids in the last ⌈proba·p⌉ rows: `select_p_worst`
    (`:94-103`)."""
    last_top = torch.ceil(proba * p).to(torch.int32)
    return (p - last_top + torch.floor(u * last_top)).to(torch.int32)


class GeneticAlgorithm:
    metaheuristic_kind = "Population"
    metaheuristic_name = "GeneticAlgorithm"

    def __init__(self, population_size, crossover_probability, p_best_rate,
                 tabu_entity_rate, mutation_rate_multiplier, move_probas,
                 migration_rate, migration_frequency, termination_strategy):
        self.population_size = int(population_size)
        self.crossover_probability = float(crossover_probability)
        self.p_best_rate = float(p_best_rate)
        self.tabu_entity_rate = float(tabu_entity_rate)
        self.mutation_rate_multiplier = mutation_rate_multiplier
        self.move_probas = move_probas
        self.migration_rate = float(migration_rate)
        self.migration_frequency = int(migration_frequency)
        self.termination_strategy = termination_strategy

    def build_kernel(self, requester, score_precision=None):
        vm = requester.variables_manager
        cfg = moves.MoverConfig(vm, self.tabu_entity_rate,
                                self.mutation_rate_multiplier, self.move_probas)
        pop_score_fn = base.make_population_score_fn(requester,
                                                     score_precision)
        p = self.population_size
        half = -(-p // 2)
        p_best_rate = self.p_best_rate
        cross_proba = self.crossover_probability
        discrete = vm.discrete_mask

        def draw(generators):
            """The step's leaves [I, ...] (`genetic_algorithm.py:81-105`):
            the two parents' and the p-worst's (proba, u) pairs, the
            crossover weight (the population's dtype), the crossover
            coin, and the children's move noise. One f64 `torch.rand` per
            island for the GA's own leaves."""
            u = moves.island_uniforms(generators, (6 * half + 2 * p,),
                                      vm.device)
            cols = torch.split(u, [half] * 6 + [p, p], dim=-1)

            def proba(x):
                # U[1e-6, p_best_rate) as `jax.random.uniform` scales it
                return torch.clamp(x * (p_best_rate - 1e-6) + 1e-6, min=1e-6)

            w = cols[4]
            if vm.float_dtype != torch.float64:
                w = moves.uniform_f32(w)
            return {"best_1": (proba(cols[0]), cols[1]),
                    "best_2": (proba(cols[2]), cols[3]),
                    "w": w[..., None],
                    "cross": (cols[5] <= cross_proba)[..., None],
                    "worst": (proba(cols[6]), cols[7]),
                    "move": moves.draw_move_noise(generators, 2 * half, vm,
                                                  cfg, vm.float_dtype)}

        def body(state, leaves):
            population, scores = state["population"], state["scores"]
            parents_1 = lexico.take_rows(population, p_best_ids(
                *leaves["best_1"], p))
            parents_2 = lexico.take_rows(population, p_best_ids(
                *leaves["best_2"], p))
            # one shared weight per pair; rint'ed for discrete genes
            w = leaves["w"]
            wg = torch.where(discrete, rint_t(w), w)
            cross = leaves["cross"]
            child_1 = torch.where(cross, parents_1 * wg
                                  + parents_2 * (1.0 - wg), parents_1)
            child_2 = torch.where(cross, parents_2 * wg
                                  + parents_1 * (1.0 - wg), parents_2)
            children = torch.cat([child_1, child_2], dim=1)

            moved, _ = moves.do_move(children, leaves["move"], vm, cfg,
                                     cfg.tabu_masks(state["tabu"]))
            candidates = vm.fix_all(moved)[:, :p]
            cand_scores = pop_score_fn(candidates)

            weak_ids = p_worst_ids(*leaves["worst"], p)
            weak = lexico.take_rows(population, weak_ids)
            weak_scores = lexico.take_rows(scores, weak_ids)
            wins = lexico.lex_leq(cand_scores, weak_scores)[..., None]
            new_pop = torch.where(wins, candidates, weak)
            new_scores = torch.where(wins, cand_scores, weak_scores)
            new_scores, new_pop = lexico.lex_sort_scores_with(new_scores,
                                                              new_pop)
            state = dict(state)
            state["population"] = new_pop
            state["scores"] = new_scores
            state = base.update_top(state)
            state["step_id"] = state["step_id"] + 1
            return state

        def step(generators, state, extras):
            return body(state, draw(generators))

        kernel = base.MetaheuristicKernel(
            self, base.plain_init_state(requester, cfg, pop_score_fn, p,
                                        sort=True),
            step, path="plain", moves_per_step=p)
        kernel.draw, kernel.body = draw, body
        return kernel
