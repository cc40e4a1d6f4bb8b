"""LSHADE — success-history adaptive differential evolution (counterpart of
`greyjack_tpu/agents/lshade.py`; reference `lshade.rs:16-108`,
`lshade_base.rs:36-432`).

Each island keeps a population f[I, P, V] sorted best first, an archive
arena of `cap = history_archive_size + P` rows with a live count, and the
success-history memories (adaptive F, CR and mutation proba, H slots, the
write slot k). A step draws, for every candidate, a memory slot, Normal CR
and mutation proba around it and a Cauchy F (8 fixed attempts, capped at
1); mutates current-to-pbest/1 over population ∪ archive; takes binomial
crossover or one move of the generic sampler; forces
`guarantee_of_change_size` random columns to the mutant; fixes and
rescores. A candidate replaces its parent when its priority score is no
worse; strict improvements are pushed to the archive (a prefix-sum
scatter, the rows that do not fit written to sentinel rows past the arena
and cut off, so no two writes share a row); past H live rows the archive
is pruned at random with a stable compaction; and the memory slot k takes
the weighted Lehmer means of the archive's F and CR.

The step is a draw (`draw`, from each island's generator) and a
deterministic body (`body`) that gives the JAX step's state when fed the
same leaves: bit for bit apart from the Cauchy `tan` and the f64 Lehmer
reductions, whose last bits differ between XLA and torch.
"""

from __future__ import annotations

import math

import torch

from greyjack_tpu_torch.agents import base
from greyjack_tpu_torch.agents.genetic_algorithm import p_best_ids
from greyjack_tpu_torch.ops import lexico, moves

_CAUCHY_ATTEMPTS = 8


def priority(scores):
    """`get_priority_score` of score rows f64[..., S]: the first positive
    level, else the last (`hard_soft_score.rs:30-36`)."""
    out = scores[..., -1]
    for i in range(scores.shape[-1] - 2, -1, -1):
        out = torch.where(scores[..., i] > 0.0, scores[..., i], out)
    return out


def normal_from_uniform(u):
    """Standard normals from f64 uniforms of [0, 1), by the inverse CDF
    `jax.random.normal` uses: sqrt(2) · erfinv(x), x uniform on
    (-1, 1)."""
    lo = torch.nextafter(torch.tensor(-1.0, dtype=u.dtype),
                         torch.tensor(0.0, dtype=u.dtype)).item()
    return math.sqrt(2.0) * torch.erfinv(torch.clamp(2.0 * u - 1.0, min=lo))


def cauchy_f(loc_f, u_c):
    """F f64[...] from the adaptive loc f64[...] and the Cauchy uniforms
    f64[..., 8] (`lshade.py:108-118`): the first positive of the 8 draws
    loc + 0.1·tan(π(u - 1/2)), capped at 1, else max(loc, 0.1). The first
    positive is an argmax of an int view (torch's argmax takes no bool)."""
    f_draws = torch.clamp(loc_f[..., None]
                          + 0.1 * torch.tan(math.pi * (u_c - 0.5)), max=1.0)
    pos = (f_draws > 0.0).to(torch.int32)
    first = torch.argmax(pos, dim=-1, keepdim=True)
    return torch.where(pos.any(dim=-1),
                       torch.gather(f_draws, -1, first)[..., 0],
                       torch.clamp(loc_f, min=0.1))


def forced_columns(gsel, cnt):
    """bool[..., V]: the `cnt[...]` columns of lowest f32 uniform
    `gsel[..., V]` (`lshade.py:158-166`). The uniforms can tie, so both
    ranks sort stably, as `jnp.argsort` does."""
    order = torch.argsort(gsel, dim=-1, stable=True)
    rank = torch.argsort(order, dim=-1, stable=True)
    return rank < cnt[..., None]


def archive_slots(arc_count, improved, cap):
    """i32[I, P] archive rows of the strictly improved candidates: live
    count plus the prefix sum of `improved` (`lshade.py:179-185`). A
    candidate that is not pushed, or does not fit, gets its own sentinel
    row cap + i past the arena, so every target row is distinct."""
    imp = improved.to(torch.int32)
    slot = arc_count[:, None] + torch.cumsum(imp, dim=-1,
                                             dtype=torch.int32) - imp
    sentinel = cap + torch.arange(improved.shape[-1], dtype=torch.int32,
                                  device=slot.device)
    return torch.where(improved & (slot < cap), slot, sentinel)


def push_rows(arena, slot, src):
    """The arena [I, cap, ...] with row slot[i, j] set to src[i, j] where
    slot < cap (`.at[slot].set(src, mode="drop")`): the writes land in the
    arena extended by one sentinel row per source row, which is cut off."""
    n_src, tail = src.shape[1], src.shape[2:]
    cap = arena.shape[1]
    pad = torch.zeros(arena.shape[:1] + (n_src,) + tail, dtype=arena.dtype,
                      device=arena.device)
    idx = slot.long().reshape(slot.shape + (1,) * len(tail))
    return torch.cat([arena, pad], dim=1).scatter(
        1, idx.expand(src.shape), src.to(arena.dtype))[:, :cap]


def prune_order(noise, arc_count, h, keep_after_prune):
    """(order i64[I, cap], new count i32[I]) of the random memory pruning
    (`lshade.py:194-208`): past h live rows, the `keep_after_prune` live
    rows of lowest noise are kept; a stable sort of the drop flags puts
    the kept rows first in their order."""
    cap = noise.shape[-1]
    need_prune = arc_count > h
    live = (torch.arange(cap, device=noise.device)[None, :]
            < arc_count[:, None])
    keyed = torch.where(live, noise, 2.0)
    keep_rank = torch.argsort(torch.argsort(keyed, dim=-1, stable=True),
                              dim=-1, stable=True)
    keep = torch.where(need_prune[:, None],
                       live & (keep_rank < keep_after_prune), live)
    order = torch.argsort((~keep).to(torch.int8), dim=-1, stable=True)
    count = torch.where(need_prune,
                        torch.clamp(arc_count, max=keep_after_prune),
                        arc_count)
    return order, count


class LSHADE:
    metaheuristic_kind = "Population"
    metaheuristic_name = "LSHADE"

    def __init__(self, population_size, history_archive_size, p_best_rate,
                 memory_pruning_rate, guarantee_of_change_size, initial_f,
                 initial_cr, initial_mutation_proba, tabu_entity_rate,
                 mutation_rate_multiplier, move_probas, migration_rate,
                 migration_frequency, termination_strategy):
        self.population_size = int(population_size)
        self.history_archive_size = int(history_archive_size)
        self.p_best_rate = float(p_best_rate)
        self.memory_pruning_rate = float(memory_pruning_rate)
        self.guarantee_of_change_size = int(guarantee_of_change_size)
        self.initial_f = float(initial_f)
        self.initial_cr = float(initial_cr)
        self.initial_mutation_proba = float(initial_mutation_proba)
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
        h = self.history_archive_size
        cap = h + p
        v = vm.variables_count
        dev = vm.device
        p_best_rate = self.p_best_rate
        g_size = self.guarantee_of_change_size
        keep_after_prune = math.ceil((1.0 - self.memory_pruning_rate) * h)
        plain_init = base.plain_init_state(requester, cfg, pop_score_fn, p,
                                           sort=True)

        def init_state(generators):
            state = plain_init(generators)
            n_isl = state["population"].shape[0]

            def full(shape, value, dtype):
                return torch.full((n_isl,) + shape, value, dtype=dtype,
                                  device=dev)

            f64, i32 = torch.float64, torch.int32
            state["archive"] = full((cap, v), 0, state["population"].dtype)
            state["arc_f"] = full((cap,), 0, f64)
            state["arc_cr"] = full((cap,), 0, f64)
            state["arc_ids"] = full((cap,), 0, i32)
            state["arc_count"] = full((), 0, i32)
            state["adaptive_f"] = full((h,), self.initial_f, f64)
            state["adaptive_cr"] = full((h,), self.initial_cr, f64)
            state["adaptive_mp"] = full((h,), self.initial_mutation_proba, f64)
            state["k"] = full((), 0, i32)
            return state

        def draw(generators):
            """The step's leaves [I, ...] (`lshade.py:96-196`): the memory
            slot, the CR and mutation-proba normals, the 8 Cauchy
            uniforms, the p-best proba and row uniforms, r1 / r2, the
            branch and crossover-mask uniforms, the children's move noise,
            the guarantee counts and column uniforms, and the prune noise.
            One f64 `torch.rand` per island for LSHADE's own leaves."""
            sizes = {"rid": p, "n_cr": p, "n_mp": p,
                     "u_c": p * _CAUCHY_ATTEMPTS, "u_pb": p, "u_pid": p,
                     "u_r1": p, "u_r2": p, "u_branch": 2 * p,
                     "u_mask": p * v, "u_prune": cap}
            if g_size > 0:
                sizes.update(cnt=p, gsel=p * v)
            u = moves.island_uniforms(generators, (sum(sizes.values()),),
                                      dev)
            n_isl = u.shape[0]
            cols = dict(zip(sizes, torch.split(u, list(sizes.values()),
                                               dim=-1)))
            leaves = {
                "rid": moves.uniform_ints(cols["rid"], 0, h),
                "n_cr": normal_from_uniform(cols["n_cr"]),
                "n_mp": normal_from_uniform(cols["n_mp"]),
                "u_c": cols["u_c"].reshape(n_isl, p, _CAUCHY_ATTEMPTS),
                # U[1e-5, p_best_rate) as `jax.random.uniform` scales it
                "u_pb": torch.clamp(cols["u_pb"] * (p_best_rate - 1e-5)
                                    + 1e-5, min=1e-5),
                "u_pid": cols["u_pid"], "u_r1": cols["u_r1"],
                "u_r2": cols["u_r2"],
                "u_branch": cols["u_branch"].reshape(n_isl, p, 2),
                "u_mask": moves.uniform_f32(cols["u_mask"]).reshape(
                    n_isl, p, v),
                "move": moves.draw_move_noise(generators, p, vm, cfg,
                                              vm.float_dtype),
                "u_prune": cols["u_prune"],
            }
            if g_size > 0:
                leaves["cnt"] = moves.uniform_ints(cols["cnt"], 1, g_size + 1)
                leaves["gsel"] = moves.uniform_f32(cols["gsel"]).reshape(
                    n_isl, p, v)
            return leaves

        rows = lexico.take_rows

        def propose(state, leaves):
            """The candidates of a step and what the replacement reads:
            {"f", "cr", "mp", "use_move", "candidates", "cand_scores"}."""
            population = state["population"]

            # --- per-candidate control parameters (`lshade_base.rs:232-246`)
            rid = leaves["rid"].long()
            cr = torch.clamp(torch.gather(state["adaptive_cr"], 1, rid)
                             + 0.1 * leaves["n_cr"], 0.0, 1.0)
            mp = torch.clamp(torch.gather(state["adaptive_mp"], 1, rid)
                             + 0.1 * leaves["n_mp"], 0.0, 1.0)
            f = cauchy_f(torch.gather(state["adaptive_f"], 1, rid),
                         leaves["u_c"])

            # --- current-to-pbest/1 over population ∪ archive (`:247-272`)
            p_best = rows(population, p_best_ids(leaves["u_pb"],
                                                 leaves["u_pid"], p))
            united_n = (p + state["arc_count"])[:, None]              # [I, 1]
            r1 = torch.floor(leaves["u_r1"] * united_n).to(torch.int32)
            r2 = torch.floor(leaves["u_r2"] * united_n).to(torch.int32)
            r2 = torch.where(r2 == r1, torch.remainder(r2 + 1, united_n), r2)

            def united_row(i):
                return torch.where(
                    (i < p)[..., None],
                    rows(population, torch.clamp(i, max=p - 1)),
                    rows(state["archive"], torch.clamp(i - p, 0, cap - 1)))

            x = population
            fb = f[..., None].to(x.dtype)
            cross_vec = x + fb * (p_best - x) + fb * (united_row(r1)
                                                      - united_row(r2))

            # --- branch: binomial crossover / mover-move (`:274-322`)
            mask = leaves["u_mask"] < cr[..., None].to(torch.float32)
            binomial_child = torch.where(mask, cross_vec, x)
            moved, _ = moves.do_move(cross_vec, leaves["move"], vm, cfg,
                                     cfg.tabu_masks(state["tabu"]))
            ub = leaves["u_branch"]
            use_move = (ub[..., 0] >= 0.5) & (ub[..., 1] <= mp)
            candidates = torch.where(use_move[..., None], moved,
                                     binomial_child)

            # --- guarantee_of_change_size forced columns (`:325-334`); the
            # f32 column uniforms can tie, so the ranks sort stably
            if g_size > 0:
                candidates = torch.where(
                    forced_columns(leaves["gsel"], leaves["cnt"]), cross_vec,
                    candidates)

            candidates = vm.fix_all(candidates)
            return {"f": f, "cr": cr, "mp": mp, "use_move": use_move,
                    "candidates": candidates,
                    "cand_scores": pop_score_fn(candidates)}

        def replace(state, leaves, prop):
            """The state after the candidates `prop` of `propose`."""
            population, scores = state["population"], state["scores"]
            candidates, cand_scores = prop["candidates"], prop["cand_scores"]
            prev_prio = priority(scores)                              # [I, P]
            cand_prio = priority(cand_scores)

            # --- replacement + archive push (`lshade_base.rs:351-409`)
            improved = cand_prio < prev_prio
            accepted = cand_prio <= prev_prio
            new_pop = torch.where(accepted[..., None], candidates, population)
            new_scores = torch.where(accepted[..., None], cand_scores, scores)

            slot = archive_slots(state["arc_count"], improved, cap)
            cand_ids = torch.arange(p, dtype=torch.int32,
                                    device=dev).expand_as(slot)
            archive = push_rows(state["archive"], slot, candidates)
            arc_f = push_rows(state["arc_f"], slot, prop["f"])
            arc_cr = push_rows(state["arc_cr"], slot, prop["cr"])
            arc_ids = push_rows(state["arc_ids"], slot, cand_ids)
            arc_count = torch.clamp(
                state["arc_count"] + torch.sum(improved, dim=-1,
                                               dtype=torch.int32), max=cap)

            # --- random memory pruning (`:376-404`)
            order, arc_count = prune_order(leaves["u_prune"], arc_count, h,
                                           keep_after_prune)
            archive = rows(archive, order)
            arc_f, arc_cr, arc_ids = (torch.gather(a, 1, order)
                                      for a in (arc_f, arc_cr, arc_ids))

            # --- weighted Lehmer-mean adaptation (`adapt_parameters`,
            # `:146-183`)
            hist_live = (torch.arange(cap, device=dev)[None, :]
                         < arc_count[:, None])
            ids = torch.clamp(arc_ids, 0, p - 1).long()
            new_prio_at = torch.gather(priority(new_scores), 1, ids)
            old_prio_at = torch.gather(prev_prio, 1, ids)
            deltas = torch.where(hist_live,
                                 torch.abs(new_prio_at - old_prio_at), 0.0)
            sum_d = torch.sum(deltas, dim=-1, keepdim=True)
            w = torch.where(sum_d == 0.0, 0.0,
                            deltas / torch.where(sum_d == 0.0, 1.0, sum_d))

            def lehmer(vals):
                num = torch.sum(w * vals * vals * hist_live, dim=-1)
                den = torch.sum(w * vals * hist_live, dim=-1)
                return torch.where(den == 0.0, 0.0,
                                   num / torch.where(den == 0.0, 1.0, den))

            new_cr_k = lehmer(arc_cr)
            new_f_k = lehmer(arc_f)
            has_hist = arc_count > 0
            k_idx = state["k"]
            at_k = (torch.arange(h, device=dev)[None, :]
                    == k_idx[:, None]) & has_hist[:, None]

            def set_at_k(memory, value):
                return torch.where(at_k, value[:, None], memory)

            adaptive_cr = set_at_k(state["adaptive_cr"], torch.where(
                new_cr_k > 0.0, new_cr_k, self.initial_cr))
            adaptive_mp = set_at_k(state["adaptive_mp"], 1.0 - new_cr_k)
            adaptive_f = set_at_k(state["adaptive_f"], torch.where(
                new_f_k > 0.0, new_f_k, self.initial_f))
            k_next = torch.where(has_hist, torch.remainder(k_idx + 1, h),
                                 k_idx)

            new_scores, new_pop = lexico.lex_sort_scores_with(new_scores,
                                                              new_pop)
            state = dict(state)
            state.update(
                population=new_pop, scores=new_scores, archive=archive,
                arc_f=arc_f, arc_cr=arc_cr, arc_ids=arc_ids,
                arc_count=arc_count, adaptive_f=adaptive_f,
                adaptive_cr=adaptive_cr, adaptive_mp=adaptive_mp, k=k_next)
            state = base.update_top(state)
            state["step_id"] = state["step_id"] + 1
            return state

        def body(state, leaves):
            return replace(state, leaves, propose(state, leaves))

        def step(generators, state, extras):
            return body(state, draw(generators))

        kernel = base.MetaheuristicKernel(self, init_state, step,
                                          path="plain", moves_per_step=p)
        kernel.draw, kernel.body, kernel.propose = draw, body, propose
        return kernel
