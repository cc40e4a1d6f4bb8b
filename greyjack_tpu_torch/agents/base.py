"""Shared agent machinery (counterpart of `greyjack_tpu/agents/base.py`),
and the one step of the local-search agents (`LocalSearch`).

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
        RuntimeWarning, stacklevel=4)


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




# --- the local-search step ---------------------------------------------------
#
# TabuSearch, LateAcceptance and SimulatedAnnealing share one step
# (`LocalSearch.build_kernel`). `scoring_path` chooses its form once; the
# form draws the proposal (`draw`), picks each island's candidate
# (`choose`), writes the accepted one back (`commit`) and ends the step
# (`finish`, the shared `step_tail`). The agent supplies its acceptance
# rule and the state it keeps for it.


def scoring_path(agent, requester, score_precision):
    """The one place a local-search agent's scoring path is chosen:
    "sweep" when asked for and the model's sweep module and the precision
    allow it; else, with a warning when the sweep was asked for, "delta"
    when the model registers delta kernels, else "plain". Returns the path
    and whether the integer fast paths are usable at this precision."""
    precision_ok = fast_paths_ok(requester, score_precision)
    if agent.sweep and requester.supports_sweep and precision_ok:
        return "sweep", precision_ok
    if agent.sweep:
        announce_fallback(agent, requester, score_precision)
    return ("delta" if requester.supports_delta else "plain"), precision_ok


def active_of(extras, state):
    """bool[I]: the runner's `_active` islands (all, when not given)."""
    active = extras.get("_active")
    if active is None:
        active = torch.ones(state["step_id"].shape, dtype=torch.bool,
                            device=state["step_id"].device)
    return active


def _first(tree):
    """Leaves [I, P, ...] -> their row 0 [I, ...], as views."""
    if isinstance(tree, dict):
        return {key: x[:, 0] for key, x in tree.items()}
    return tree[:, 0]


def choose_best(p, key):
    """Each island's candidate of the neighbourhood p["rows"] [I, P, S]:
    the lexicographically best row (lowest index on ties; row 0, with no
    search, where P = 1) as p["cand"], and p[key] and the tabu info picked
    there. The info of P > 1 is picked by the step tail, and only where
    tabu is on: p["chosen"] holds the index (None once picked)."""
    rows = p["rows"]
    if rows.shape[1] == 1:
        p["chosen"], p["cand"] = None, rows[:, 0]
        p[key], p["info"] = _first(p[key]), _first(p["info"])
        return
    p["chosen"] = lexico.lex_argmin(rows)                          # [I]
    p["cand"] = moves.take_one(rows, p["chosen"])
    p[key] = moves.take_one(p[key], p["chosen"])


def step_tail(cfg, state, info, chosen=None, active=None):
    """The end of every local-search step: the tabu push of the chosen
    neighbour's touched slots (`info` [I, ...], or [I, P, ...] picked at
    `chosen`; count 0 where `active` is False), the island best and the
    step count (advanced by `active`). Without `active` the runner masks
    inactive islands."""
    if cfg.use_tabu:
        row = info if chosen is None else moves.take_one(info, chosen)
        count = (row["count"] if active is None
                 else torch.where(active, row["count"], 0))
        state["tabu"] = selection.tabu_push(state["tabu"], row["group"],
                                            row["positions"], count)
    state = update_top(state)
    state["step_id"] = state["step_id"] + (
        1 if active is None else active.to(state["step_id"].dtype))
    return state


class _Form:
    refresh = prestep = None

    def finish(self, state, p):
        return step_tail(self.cfg, state, p["info"], p["chosen"],
                         p["active"])


class PlainMoveStep(_Form):
    """The plain form, for cotwins without delta kernels: each neighbour is
    a copy of the island's solution moved by the generic sampler, fixed and
    scored by one plain call; the best replaces the solution where
    accepted. Not self-gating: the runner masks inactive islands."""
    path = label = "plain"
    self_gating = False

    def __init__(self, agent, requester, cfg, score_precision,
                 precision_ok):
        self.vm = requester.variables_manager
        self.cfg = cfg
        self.moves_per_step = agent.neighbours
        self.pop_score_fn = make_population_score_fn(requester,
                                                     score_precision)
        self.init_state = plain_init_state(requester, cfg, self.pop_score_fn,
                                           1)

    def propose(self, generators, state, candidates):
        """(moved f[I, P, V], info, scores f64[I, P, S]) of `candidates`."""
        moved, info = moves.move_population(generators, candidates, self.vm,
                                            self.cfg, state["tabu"])
        return moved, info, self.pop_score_fn(moved)

    def draw(self, generators, state, extras):
        moved, info, rows = self.propose(
            generators, state,
            state["population"].expand(-1, self.moves_per_step, -1))
        return {"moved": moved, "info": info, "rows": rows, "active": None,
                "gate": None, "exact": None}

    def choose(self, state, p):
        choose_best(p, "moved")

    def commit(self, state, p, accept):
        keep = accept[:, None, None]
        state["population"] = torch.where(keep, p["moved"][:, None],
                                          state["population"])
        state["scores"] = torch.where(keep, p["cand"][:, None],
                                      state["scores"])
        return p["cand"]


class CtxStep(_Form):
    """What the forms that carry a delta ctx per island share: the initial
    state, the per-chunk ctx rebuild after migration, the per-step tabu
    free lists, the score row of an exact integer delta row and the
    winner-commit tail."""

    def __init__(self, requester, cfg, score_precision, precision_ok):
        self.requester = requester
        self.vm = requester.variables_manager
        self.cfg = cfg
        self.score_fn = make_score_fn(requester, score_precision)
        # accept-boundary rounding (None when unrounded): candidate row =
        # rounded((ctx_ints + exact) / scales)
        self.ints_to_row = (make_rounded_ints_to_row_fn(
            requester, score_precision)
            if score_precision is not None and precision_ok else None)

    def init_state(self, generators):
        population = torch.stack(
            [self.vm.sample_variables(g, 1) for g in generators])  # [I, 1, V]
        n_isl, _, v = population.shape
        scores = self.score_fn(population.reshape(n_isl, v)).reshape(
            n_isl, 1, -1)
        state = base_state(population, scores)
        state["tabu"] = self.cfg.init_tabu_state(n_isl)
        state["ctx"] = self.requester.build_base_ctx(population[:, 0])
        return state

    def refresh(self, state):
        state = dict(state)
        state["ctx"] = self.requester.build_base_ctx(
            state["population"][:, 0])
        return state

    def tabu_free(self, state):
        return {"_free": self.cfg.tabu_free(state["tabu"])}

    def int_row(self, state, exact, unrounded=None):
        """f64[I, S]: the score row of the base plus the exact integer delta
        row `exact` — rounded from the ctx's integer totals under
        score_precision; unrounded, `unrounded(ctx, exact)`, or None where
        the agent needs no row (its rule reads the sign of `exact`)."""
        if self.ints_to_row is None:
            return None if unrounded is None else unrounded(state["ctx"],
                                                            exact)
        return self.ints_to_row(self.requester.ctx_int_totals(state["ctx"])
                                + exact.to(torch.int64))

    def commit(self, state, p, accept):
        """Apply each island's winning delta p["winner"] (leaves [I, K])
        where `accept` holds, to the chromosome and the ctx, and store its
        row there: p["cand"], or the updated ctx's row where the step made
        none. Returns that row."""
        winner = {**p["winner"], "valid": p["winner"]["valid"]
                  & accept[:, None]}
        with span("gj.agent.apply"):
            state["population"] = moves.apply_delta(
                state["population"][:, 0], winner)[:, None]
        state["ctx"] = self.requester.update_ctx(state["ctx"], winner)
        new_score = (p["cand"] if p["cand"] is not None
                     else self.requester.ctx_score_row(state["ctx"]))
        state["scores"] = torch.where(accept[:, None, None],
                                      new_score[:, None, :], state["scores"])
        return new_score


class DeltaStep(CtxStep):
    """The delta form: moves off the island's solution scored as rows
    against its ctx. TabuSearch's (`ranks_neighbourhood`) ranks
    `neighbours_count` of them on exact i32 rows where the model and the
    fused kernel serve this width, else on f64 rows, and gates itself; the
    other agents score one move as an f64 row and the runner masks them."""
    path = "delta"

    def __init__(self, agent, requester, cfg, score_precision,
                 precision_ok):
        super().__init__(requester, cfg, score_precision, precision_ok)
        ranks = agent.ranks_neighbourhood
        ints_ok = ranks and precision_ok
        self.moves_per_step = agent.neighbours
        self.self_gating = ranks
        # the free lists feed the narrow sampler only
        self.prestep = self.tabu_free if ranks and cfg.narrow else None
        self.ints = ints_ok and requester.delta_ints_eligible(
            cfg.delta_width)
        # the label is the JAX package's (`tabu_search.py:181-191`):
        # "int-delta" whenever the model registers the integer rows and
        # precision allows, even where the i32 route turns this width or
        # instance down (kd 16, i64 bounds) and the step scores f64 rows
        self.label = ("int-delta" if ints_ok
                      and requester.registers_delta_ints else "delta")
        self.delta_score_fn = make_delta_score_fn(requester, score_precision)

    def draw(self, generators, state, extras):
        deltas, info = moves.move_population_delta(
            generators, state["population"][:, 0], self.moves_per_step,
            self.vm, self.cfg, state["tabu"], extras.get("_free"))
        if self.ints:
            rows = self.requester.request_score_delta_ints(state["ctx"],
                                                           deltas)
        else:
            rows = self.delta_score_fn(state["ctx"], deltas)    # [I, P, S]
        active = active_of(extras, state) if self.self_gating else None
        return {"winner": deltas, "info": info, "rows": rows,
                "active": active, "gate": active, "exact": None}

    def choose(self, state, p):
        choose_best(p, "winner")
        if self.ints:
            # rank and accept on exact i32 deltas; the f64 row comes from
            # the ctx's sums
            p["exact"] = p["cand"]
            p["cand"] = self.int_row(state, p["exact"])


class SweepStep(CtxStep):
    """The sweep form: each island's winner over the model's dense value
    sweeps (`propose` of `models/vrp/sweep.py`, `models/tsp/sweep.py`) with
    its exact integer delta row; self-gating, and counting the scored and
    non-converged candidates."""
    path = label = "sweep"
    self_gating = True

    def __init__(self, agent, requester, cfg, score_precision,
                 precision_ok):
        super().__init__(requester, cfg, score_precision, precision_ok)
        self.mod = requester.sweep_module
        self.sweep_cfg = self.mod.SweepConfig(requester, agent.sweep_targets,
                                              agent.sweep_window)
        self.utils = requester._delta_utils()
        self.prestep = self.tabu_free
        # unrounded, TabuSearch accepts on the sign of the exact row and
        # stores the updated ctx's row; the other rules compare the row
        self.unrounded = (None if agent.ranks_neighbourhood
                          else self.exact_row)
        self.moves_per_step = self.sweep_cfg.conservative_moves_per_step(
            self.utils, agent.tabu_entity_rate)

    def exact_row(self, ctx, exact):
        return self.mod.exact_score_row(ctx, exact, self.utils)

    def init_state(self, generators):
        state = super().init_state(generators)
        zeros = torch.zeros(state["step_id"].shape, dtype=torch.int64,
                            device=state["step_id"].device)
        state["sweep_scored"] = zeros
        # candidates whose lateness was a bound, not exact
        state["sweep_nonconv"] = zeros
        return state

    def draw(self, generators, state, extras):
        """The `active` islands, the `gate` (active and a winner exists),
        the `winner` delta (leaves [I, K]), its `exact` integer [I, S]
        delta row (`STUB_INT` where there is no winner), the tabu `info`
        and the `stats` counters."""
        with span("gj.agent.propose"):
            active = active_of(extras, state)
            free = extras.get("_free")
            if free is None:
                free = self.cfg.tabu_free(state["tabu"])
            delta, exact, info, stats = self.mod.propose(
                generators, state["ctx"], free,
                self.cfg.tabu_masks(state["tabu"]), self.sweep_cfg,
                self.utils)
            return {"active": active,
                    "gate": active & (exact[:, 0] != STUB_INT),
                    "winner": delta, "exact": exact, "info": info,
                    "stats": stats, "chosen": None}

    def choose(self, state, p):
        p["cand"] = self.int_row(state, p["exact"], self.unrounded)

    def finish(self, state, p):
        active, stats = p["active"], p["stats"]
        state["sweep_scored"] = state["sweep_scored"] + torch.where(
            active, stats["n_scored"], 0)
        state["sweep_nonconv"] = state["sweep_nonconv"] + torch.where(
            active, stats["n_nonconv"], 0)
        # the reference pushes touched ids during sampling
        # (`mover.rs:75-96`): the winner's targets enter tabu whether or
        # not accepted, rotating sweep targets out of tabu
        return super().finish(state, p)


_FORMS = {"sweep": SweepStep, "delta": DeltaStep, "plain": PlainMoveStep}


class LocalSearch:
    """The step of the local-search agents: propose, pick each island's
    candidate, accept by the agent's rule, commit, end the step. The agent
    gives its rule (`accept`), what it keeps of an outcome (`accepted`)
    and its own state (`init_rule`); every hook sees the proposal p of the
    step: its form's `path`, the candidate row `cand` (None where the rule
    may read the sign of the `exact` integer delta row), `active`
    (None where the runner masks), `generators` and `extras`."""
    metaheuristic_kind = "LocalSearch"
    # TabuSearch's step: a neighbourhood of `neighbours_count` moves ranked
    # on exact integer rows where the model serves them, accepted on the
    # exact delta's sign when unrounded, and a self-gating delta form.
    # The others score one move as an f64 row
    ranks_neighbourhood = False

    @property
    def neighbours(self):
        return 1

    def init_rule(self, state, path):
        return state

    def accept(self, state, p):
        """bool[I]: the islands whose candidate the rule accepts, before
        the form's own gate (active, a winner exists)."""
        raise NotImplementedError

    def accepted(self, state, p, accept, new_score):
        """Update the rule's state after the commit."""

    def build_kernel(self, requester, score_precision=None):
        cfg = moves.MoverConfig(requester.variables_manager,
                                self.tabu_entity_rate,
                                self.mutation_rate_multiplier,
                                self.move_probas)
        path, precision_ok = scoring_path(self, requester, score_precision)
        form = _FORMS[path](self, requester, cfg, score_precision,
                            precision_ok)

        def init_state(generators):
            return self.init_rule(form.init_state(generators), form.path)

        def step(generators, state, extras):
            p = form.draw(generators, state, extras)
            p.update(path=form.path, generators=generators, extras=extras)
            with span("gj.agent.accept"):
                state = dict(state)
                form.choose(state, p)
                accept = self.accept(state, p)
                if p["gate"] is not None:
                    accept = accept & p["gate"]
                new_score = form.commit(state, p, accept)
                self.accepted(state, p, accept, new_score)
                return form.finish(state, p)

        return MetaheuristicKernel(
            self, init_state, step, form.refresh,
            self_gating=form.self_gating, prestep=form.prestep,
            path=form.label, moves_per_step=form.moves_per_step)
