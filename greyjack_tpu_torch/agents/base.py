"""Shared agent machinery (counterpart of `greyjack_tpu/agents/base.py`).

An agent ("island") state is a dict of tensors; all islands of a run are
one state with a leading island axis I (the JAX package's island vmap,
written out). A metaheuristic provides

    init_state(generators)           -> state ([I, ...] leaves)
    step(generators, state, extras)  -> state

with one `torch.Generator` per island. `extras` carries per-step values the
runner injects (`_active`: bool[I] for self-gating kernels, `_free`: the
tabu free lists, the SA auto-temperature `inverted_accomplish_rate`: f64[I]).
"""

from __future__ import annotations

import sys
import warnings

import torch

from greyjack_tpu_torch.ops import lexico, moves, selection
from greyjack_tpu_torch.utils.math_utils import round_decimal_t
from greyjack_tpu_torch.utils.tracing import span

# the reference's f64::MAX-1 sentinel score component
STUB = sys.float_info.max - 1.0
# the sweep modules' stub of an exact integer row with no winner, whether
# the row is i32 or i64
STUB_INT = (1 << 31) - 1


class MetaheuristicKernel:
    """Bundle of device functions handed to the island runner.

    `refresh` (optional) re-derives state that is a pure function of the
    population — e.g. the delta-scoring ctx — after the runner replaced
    individuals (migration, global-best adoption); called once per chunk.
    `prestep(state) -> extras` runs once per step for all islands before
    `step`. `path` names the scoring path the kernel runs ("sweep" /
    "int-delta" / "delta"); `moves_per_step` counts scored candidates per
    island-step (a static lower bound for sweep kernels); "plain" kernels
    score whole candidates with a full rescore.

    `self_gating`: the step reads extras["_active"] (bool[I]) and freezes
    all its own writes for inactive islands. Otherwise the runner keeps an
    inactive island's whole state with `mask_state` after the step."""

    def __init__(self, builder, init_state, step, refresh=None,
                 self_gating=False, prestep=None, path=None,
                 moves_per_step=None):
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
        self.self_gating = self_gating


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
    """True when the int-delta / sweep fast paths are usable at this precision:
    always for unrounded scores; for rounded scores only when the model
    registered its exact integer totals."""
    if score_precision is None:
        return True
    return requester.supports_rounded_fast_paths


def announce_fallback(builder, requester, score_precision):
    """Warn when a requested sweep mode cannot engage, naming the reason
    (a silent fallback would hide which path ran)."""
    if not requester.supports_sweep:
        reason = ("the model registered no eligible sweep module for this "
                  "instance")
    elif not fast_paths_ok(requester, score_precision):
        reason = ("score_precision is set and the model did not register "
                  "exact integer totals (set_delta_kernels(ctx_ints=...)) "
                  "for accept-boundary rounding")
    else:
        return
    warnings.warn(
        f"{builder.metaheuristic_name}: sweep=True requested but the sweep "
        f"fast path cannot engage — {reason}; falling back to the "
        "random-move path (orders of magnitude fewer scored moves/s)",
        RuntimeWarning, stacklevel=3)


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


def make_population_score_fn(requester, score_precision=None):
    """population f[I, P, V] -> f64[I, P, S]: one plain score call over
    the I·P rows flattened, reshaped back."""
    score_fn = make_score_fn(requester, score_precision)

    def fn(population):
        n_isl, p, v = population.shape
        return score_fn(population.reshape(n_isl * p, v)).reshape(n_isl, p,
                                                                  -1)

    return fn


def plain_init_state(requester, cfg, pop_score_fn, population_size,
                     sort=False):
    """`init_state(generators)` of the plain kernels: `population_size`
    candidates sampled per island from its generator, scored, and — for
    Population kernels (`sort`) — lexicographically sorted, best first;
    plus the island's tabu rings."""
    vm = requester.variables_manager

    def init_state(generators):
        population = torch.stack([vm.sample_variables(g, population_size)
                                  for g in generators])           # [I, P, V]
        scores = pop_score_fn(population)
        if sort:
            scores, population = lexico.lex_sort_scores_with(scores,
                                                             population)
        state = base_state(population, scores)
        state["tabu"] = cfg.init_tabu_state(len(generators))
        return state

    return init_state


class PlainMoveStep:
    """The parts the plain local-search steps (TabuSearch, LateAcceptance,
    SimulatedAnnealing with a full rescore) share: move every candidate
    with the generic sampler, fix it, score it in one plain call; after
    the accept rule, keep the accepted candidate, push the chosen
    neighbour's touched slots into the tabu rings and refresh the island
    best. These steps are not self-gating: the runner masks inactive
    islands."""

    def __init__(self, requester, cfg, score_precision):
        self.vm = requester.variables_manager
        self.cfg = cfg
        self.pop_score_fn = make_population_score_fn(requester,
                                                     score_precision)

    def propose(self, generators, state, candidates):
        """(moved f[I, P, V], info, scores f64[I, P, S]) of `candidates`."""
        moved, info = moves.move_population(generators, candidates, self.vm,
                                            self.cfg, state["tabu"])
        return moved, info, self.pop_score_fn(moved)

    def accept(self, state, moved, scores, accept, info, chosen):
        """The island's candidate moved f[I, 1, V] with rows f64[I, 1, S]
        replaces its solution where `accept` (bool[I]); then the tabu push
        of neighbour `chosen` (int[I]), the island best and the step."""
        with span("gj.agent.accept"):
            state = dict(state)
            keep = accept[:, None, None]
            state["population"] = torch.where(keep, moved,
                                              state["population"])
            state["scores"] = torch.where(keep, scores, state["scores"])
            if self.cfg.use_tabu:
                state["tabu"] = moves.update_tabu_from_info(
                    state["tabu"], info, chosen)
            state = update_top(state)
            state["step_id"] = state["step_id"] + 1
            return state


def make_delta_score_fn(requester, score_precision=None):
    """(ctx, deltas [I, P, K]) -> f64[I, P, S] with optional decimal
    rounding. The delta arithmetic is exact integer arithmetic, so
    base + delta then round equals a full rescore then round."""
    if score_precision is not None:
        precision = list(score_precision)

        def fn(ctx, deltas):
            return round_decimal_t(requester.request_score_delta(ctx, deltas),
                                   precision)

        return fn
    return requester.request_score_delta


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


def mask_state(new_state, old_state, alive):
    """Freeze dead islands: keep the old state where `alive` (bool[I]) is
    False (`agent_base.rs:137-146`: dead agents stop stepping but keep
    relaying). Every leaf carries the leading island axis."""

    def mask(new, old):
        if isinstance(new, dict):
            return {key: mask(new[key], old[key]) for key in new}
        return torch.where(alive.view(alive.shape + (1,) * (new.dim() - 1)),
                           new, old)

    return mask(new_state, old_state)


def ctx_state_fns(requester, cfg, score_fn):
    """(init_state, refresh, prestep) of the kernels that carry a delta ctx
    per island: the initial population, scores, tabu rings and ctx; the
    per-chunk ctx rebuild after migration; the per-step tabu free lists."""
    vm = requester.variables_manager

    def init_state(generators):
        population = torch.stack(
            [vm.sample_variables(g, 1) for g in generators])      # [I, 1, V]
        n_isl, _, v = population.shape
        scores = score_fn(population.reshape(n_isl, v)).reshape(n_isl, 1, -1)
        state = base_state(population, scores)
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


def apply_winner(requester, state, winner, accept, cand):
    """Apply each island's winning delta (leaves [I, K]) where `accept`
    (bool[I]) holds, to the chromosome and the ctx, and store its score
    row `cand` f64[I, S] there. Returns a new state dict."""
    with span("gj.agent.accept"):
        winner = {**winner, "valid": winner["valid"] & accept[:, None]}
        state = dict(state)
        with span("gj.agent.apply"):
            state["population"] = moves.apply_delta(
                state["population"][:, 0], winner)[:, None]
        state["ctx"] = requester.update_ctx(state["ctx"], winner)
        state["scores"] = torch.where(accept[:, None, None],
                                      cand[:, None, :], state["scores"])
        return state


class RandomMoveStep:
    """The parts of the LateAcceptance / SimulatedAnnealing random-move
    steps that do not depend on the accept rule: one move per island,
    scored as an f64 row against the ctx in state, and the bookkeeping
    after the write-back. These steps are not self-gating."""

    def __init__(self, requester, cfg, score_precision):
        self.requester = requester
        self.cfg = cfg
        self.delta_score_fn = make_delta_score_fn(requester, score_precision)

    def propose(self, generators, state):
        """(winner delta leaves [I, K], tabu info, candidate row f64[I, S])."""
        deltas, info = moves.move_population_delta(
            generators, state["population"][:, 0], 1,
            self.requester.variables_manager, self.cfg, state["tabu"])
        cand = self.delta_score_fn(state["ctx"], deltas)[:, 0]
        return {key: x[:, 0] for key, x in deltas.items()}, info, cand

    def finish(self, state, info):
        with span("gj.agent.accept"):
            if self.cfg.use_tabu:
                state["tabu"] = moves.update_tabu_from_info(
                    state["tabu"], info,
                    torch.zeros_like(state["step_id"], dtype=torch.int64))
            state = update_top(state)
            state["step_id"] = state["step_id"] + 1
            return state


class SweepStep:
    """The parts every sweep kernel's step shares: the sweep winner of each
    island (the model's sweep module's `propose`: `models/vrp/sweep.py`,
    `models/tsp/sweep.py`), its exact score row, and the
    bookkeeping after the accept rule — the winner's tabu push, the sweep
    counters, the island best and the step count, each frozen where
    `_active` is False (the sweep kernels are self-gating)."""

    def __init__(self, agent, requester, cfg, score_precision):
        self.requester = requester
        self.cfg = cfg
        self.mod = requester.sweep_module
        self.sweep_cfg = self.mod.SweepConfig(requester, agent.sweep_targets,
                                              agent.sweep_window)
        self.utils = requester._delta_utils()
        # accept-boundary rounding (None when unrounded): candidate row =
        # rounded((ctx_ints + exact) / scales)
        self.ints_to_row = (make_rounded_ints_to_row_fn(
            requester, score_precision)
            if score_precision is not None else None)
        self.moves_per_step = self.sweep_cfg.conservative_moves_per_step(
            self.utils, agent.tabu_entity_rate)

    def init_counters(self, state):
        zeros = torch.zeros(state["step_id"].shape, dtype=torch.int64,
                            device=state["step_id"].device)
        state["sweep_scored"] = zeros
        # candidates whose lateness was a bound, not exact
        state["sweep_nonconv"] = zeros
        return state

    def propose(self, generators, state, extras):
        """dict of `active` bool[I], `ok` (active and a winner exists),
        the winner `delta` (leaves [I, K]), its `exact` integer [I, S]
        delta row (`STUB_INT` where there is no winner), the tabu `info`
        and the `stats` counters."""
        with span("gj.agent.propose"):
            active = extras.get("_active")
            if active is None:
                active = torch.ones(state["step_id"].shape, dtype=torch.bool,
                                    device=state["step_id"].device)
            free = extras.get("_free")
            if free is None:
                free = self.cfg.tabu_free(state["tabu"])
            delta, exact, info, stats = self.mod.propose(
                generators, state["ctx"], free,
                self.cfg.tabu_masks(state["tabu"]), self.sweep_cfg,
                self.utils)
            ok = active & (exact[:, 0] != STUB_INT)
            return {"active": active, "ok": ok, "delta": delta,
                    "exact": exact, "info": info, "stats": stats}

    def cand_row(self, state, exact):
        """f64[I, S]: the score row of the base plus the exact delta."""
        if self.ints_to_row is None:
            return self.mod.exact_score_row(state["ctx"], exact, self.utils)
        return self.ints_to_row(self.requester.ctx_int_totals(state["ctx"])
                                + exact.to(torch.int64))

    def finish(self, state, p):
        with span("gj.agent.accept"):
            active, info, stats = p["active"], p["info"], p["stats"]
            if self.cfg.use_tabu:
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
            state = update_top(state)
            state["step_id"] = state["step_id"] + active.to(
                state["step_id"].dtype)
            return state
