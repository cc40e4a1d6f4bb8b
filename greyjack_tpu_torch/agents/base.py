"""Shared agent machinery (counterpart of `greyjack_tpu/agents/base.py`).

An agent ("island") state is a dict of tensors; all islands of a run are
one state with a leading island axis I (the JAX package's island vmap,
written out). A metaheuristic provides

    init_state(generators)           -> state ([I, ...] leaves)
    step(generators, state, extras)  -> state

with one `torch.Generator` per island. `extras` carries per-step values the
runner injects (`_active`: bool[I], `_free`: the tabu free lists).
"""

from __future__ import annotations

import torch

from greyjack_tpu_torch.ops import lexico
from greyjack_tpu_torch.utils.math_utils import round_decimal_t


class MetaheuristicKernel:
    """Bundle of device functions handed to the island runner.

    `refresh` (optional) re-derives state that is a pure function of the
    population — e.g. the delta-scoring ctx — after the runner replaced
    individuals (migration, global-best adoption); called once per chunk.
    `prestep(state) -> extras` runs once per step for all islands before
    `step`. The step reads extras["_active"] (bool[I]) and freezes all its
    own writes for inactive islands. `path` names the scoring path the
    kernel runs ("int-delta"); `moves_per_step` counts scored candidates per
    island-step."""

    def __init__(self, builder, init_state, step, refresh=None,
                 prestep=None, path=None, moves_per_step=None):
        self.builder = builder
        self.init_state = init_state
        self.step = step
        self.refresh = refresh
        self.path = path
        self.moves_per_step = moves_per_step
        self.prestep = prestep
        self.metaheuristic_kind = builder.metaheuristic_kind
        self.population_size = builder.population_size
        self.migration_rate = builder.migration_rate


def make_rounded_ints_to_row_fn(requester, score_precision):
    """(int_totals i64[..., S]) -> f64[..., S] score rows, decimal-rounded
    when `score_precision` is set: `ints / scales` reproduces the plain
    scorer's f64 rows bit-for-bit, so rounding here equals rounding a full
    rescore (`agent_base.rs:284-287`)."""
    scales = requester.score_int_scales

    def fn(ints):
        row = ints.to(torch.float64) / scales
        if score_precision is not None:
            row = round_decimal_t(row, list(score_precision))
        return row

    return fn


def fast_paths_ok(requester, score_precision):
    """True when the int-delta fast path is usable at this precision:
    always for unrounded scores; for rounded scores only when the model
    registered its exact integer totals."""
    if score_precision is None:
        return True
    return requester.supports_rounded_fast_paths


def make_score_fn(requester, score_precision=None):
    """population f[P, V] -> scores f64[P, S], with optional truncating
    decimal rounding per component (`agent_base.rs:284-287`)."""
    if score_precision is not None:
        precision = list(score_precision)

        def fn(population):
            return round_decimal_t(requester.request_score_plain(population),
                                   precision)

        return fn
    return requester.request_score_plain


def base_state(population, scores):
    """Common per-island state fields: population f[I, P, V], scores
    f64[I, P, S]."""
    top_idx = lexico.lex_argmin(scores)
    ar = torch.arange(population.shape[0], device=population.device)
    return {
        "population": population,
        "scores": scores,
        "top_values": population[ar, top_idx],
        "top_score": scores[ar, top_idx],
        "step_id": torch.zeros(population.shape[0], dtype=torch.int32,
                               device=population.device),
    }


def update_top(state):
    """Refresh each island's best from its current population
    (`agent_base.rs:220-224`)."""
    idx = lexico.lex_argmin(state["scores"])
    ar = torch.arange(idx.shape[0], device=idx.device)
    cand_score = state["scores"][ar, idx]
    better = lexico.lex_leq(cand_score, state["top_score"])
    state = dict(state)
    state["top_values"] = torch.where(better[:, None],
                                      state["population"][ar, idx],
                                      state["top_values"])
    state["top_score"] = torch.where(better[:, None], cand_score,
                                     state["top_score"])
    return state

