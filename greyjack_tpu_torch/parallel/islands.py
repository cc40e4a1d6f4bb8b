"""Island-model runner on one device (counterpart of
`greyjack_tpu/parallel/islands.py`; reference `solver.rs:85-143`,
`agent_base.rs:124-188`).

Islands are a leading tensor axis [I, ...]; one chunk advances every island
`n_steps` steps (a Python loop), then runs ring migration (`torch.roll` by
one: island i receives from island i-1), the lexicographic global-best
reduce with adoption, and the per-chunk `refresh`. Dead islands are frozen
by their step budget but keep relaying: a self-gating kernel freezes them
itself, any other kernel's step (every plain kernel) is followed by
`mask_state`. Two arms: LocalSearch (one individual an island; the
LateAcceptance ring in migration and adoption) and Population (an island's
top `migrants_count` replace its ring successor's worst where no worse,
then a re-sort; no adoption of the global best). Multi-device meshes
raise.
"""

from __future__ import annotations

import math

import torch

from greyjack_tpu_torch.agents import base as agent_base
from greyjack_tpu_torch.agents import late_acceptance as la_mod
from greyjack_tpu_torch.ops import lexico


class IslandRunner:
    def __init__(self, kernel, n_islands, migration_frequency, mesh=None,
                 compare_to_global=True):
        if mesh is not None:
            raise NotImplementedError(
                "multi-device islands are not ported yet (ROADMAP Queue 1 "
                "item 9)")
        self.kernel = kernel
        self.n_islands = int(n_islands)
        self.migration_frequency = int(migration_frequency)
        self.compare_to_global = compare_to_global
        self.kind = kernel.metaheuristic_kind
        if self.kind == "Population":
            self.migrants_count = max(
                1, math.ceil(kernel.migration_rate * kernel.population_size))
        else:
            self.migrants_count = 1

    def init(self, generators):
        """Initial run state from one generator per island."""
        if len(generators) != self.n_islands:
            raise ValueError("need one generator per island")
        islands = self.kernel.init_state(generators)
        pop = islands["population"]
        s = islands["scores"].shape[-1]
        return {
            "islands": islands,
            "global_values": torch.zeros(pop.shape[-1], dtype=pop.dtype,
                                         device=pop.device),
            "global_score": lexico.stub_score_row(s, device=pop.device),
        }

    def run_chunk(self, state, generators, alive, extras, n_steps,
                  steps_left=None):
        """Advance all islands `n_steps` steps, then migrate + reduce the
        global best + refresh. alive: bool[I]; steps_left: i32[I] per-island
        budget (islands freeze after it inside the chunk, so StepsLimit
        stays exact). extras: f64[I] per-island values; an entry `<k>_end`
        pairs with `<k>` to interpolate it linearly over the chunk's steps
        (the per-step SA auto-temperature, `agent_base.rs:537-552`)."""
        if steps_left is None:
            steps_left = torch.full(alive.shape, n_steps, dtype=torch.int32,
                                    device=alive.device)
        islands = self._steps(state["islands"], generators, alive,
                              steps_left, extras, n_steps)
        islands = self._migrate(islands)
        state = self._update_global(state, islands)
        return self._refresh(state)

    def _steps(self, islands, generators, alive, steps_left, extras, n_steps):
        step = self.kernel.step
        ends = {k for k in extras if k.endswith("_end")}
        lerped = {k for k in extras if k + "_end" in ends}
        for i in range(n_steps):
            # per-step extras: `<k>` .. `<k>_end` lerped by step index; for
            # StepsLimit the accomplish rate is linear in steps, so the lerp
            # is exact
            frac = i / n_steps
            ex = {k: (v + (extras[k + "_end"] - v) * frac) if k in lerped
                  else v for k, v in extras.items() if k not in ends}
            act = alive & (i < steps_left)
            if self.kernel.prestep is not None:
                ex.update(self.kernel.prestep(islands))
            if self.kernel.self_gating:
                # the kernel freezes its own writes for inactive islands
                islands = step(generators, islands, {**ex, "_active": act})
            else:
                islands = agent_base.mask_state(
                    step(generators, islands, ex), islands, act)
        return islands

    def _refresh(self, state):
        """Re-derive population-dependent state (the delta ctx) after
        migration / adoption replaced individuals — once per chunk."""
        if self.kernel.refresh is None:
            return state
        state = dict(state)
        state["islands"] = self.kernel.refresh(state["islands"])
        return state

    def _migrate(self, islands):
        """Ring exchange + acceptance (`agent_base.rs:322-444`)."""
        if self.kind == "Population":
            return self._migrate_population(islands)
        return self._migrate_local(islands)

    def _migrate_population(self, islands):
        """Population arm (`greyjack_tpu/parallel/islands.py:235-249`):
        island i's worst k (rows P-k..P-1) each take the matching one of
        its ring predecessor's best k (rows 0..k-1) where that migrant is
        no worse, then the island re-sorts."""
        k = self.migrants_count
        pop = islands["population"]                           # [I, P, V]
        scores = islands["scores"]                            # [I, P, S]
        p = pop.shape[1]
        mig_v = torch.roll(pop[:, :k], 1, dims=0)
        mig_s = torch.roll(scores[:, :k], 1, dims=0)
        accept = lexico.lex_leq(mig_s, scores[:, p - k:])[..., None]
        pop = torch.cat([pop[:, :p - k],
                         torch.where(accept, mig_v, pop[:, p - k:])], dim=1)
        scores = torch.cat([scores[:, :p - k],
                            torch.where(accept, mig_s, scores[:, p - k:])],
                           dim=1)
        scores, pop = lexico.lex_sort_scores_with(scores, pop)
        islands = dict(islands)
        islands["population"] = pop
        islands["scores"] = scores
        return agent_base.update_top(islands)

    def _migrate_local(self, islands):
        """LocalSearch arm: each island takes its ring predecessor's
        individual when it is no worse — for LateAcceptance, no worse than
        the ring's oldest entry or the current score, and the migrant's
        score is pushed (`agent_base.rs:416-428`)."""
        pop = islands["population"]                           # [I, 1, V]
        scores = islands["scores"]                            # [I, 1, S]
        mig_v = torch.roll(pop[:, 0], 1, dims=0)
        mig_s = torch.roll(scores[:, 0], 1, dims=0)
        islands = dict(islands)
        if "late" in islands:
            accept = la_mod.late_accept(mig_s, scores[:, 0], islands["late"])
            islands["late"] = la_mod.ring_push_front(islands["late"], mig_s,
                                                     accept)
        else:
            accept = lexico.lex_leq(mig_s, scores[:, 0])
        pop = pop.clone()
        scores = scores.clone()
        pop[:, 0] = torch.where(accept[:, None], mig_v, pop[:, 0])
        scores[:, 0] = torch.where(accept[:, None], mig_s, scores[:, 0])
        islands["population"] = pop
        islands["scores"] = scores
        return agent_base.update_top(islands)

    def _update_global(self, state, islands):
        """Lexicographic global-best reduce + adoption
        (`agent_base.rs:446-490`)."""
        tops_v = islands["top_values"]                        # [I, V]
        tops_s = islands["top_score"]                         # [I, S]
        cand_v = torch.cat([tops_v, state["global_values"][None]], dim=0)
        cand_s = torch.cat([tops_s, state["global_score"][None]], dim=0)
        best = lexico.lex_argmin(cand_s)
        g_v = cand_v[best]
        g_s = cand_s[best]

        if self.kind == "LocalSearch" and self.compare_to_global:
            # adopt the global best where strictly better than the island
            # top; Population islands never adopt
            adopt = lexico.lex_less(g_s, islands["top_score"])  # [I]
            islands = dict(islands)
            if "late" in islands:
                # LateAcceptance pushes the pre-adoption score
                islands["late"] = la_mod.ring_push_front(
                    islands["late"], islands["scores"][:, 0], adopt)
            pop = islands["population"].clone()
            scores = islands["scores"].clone()
            pop[:, 0] = torch.where(adopt[:, None], g_v[None, :], pop[:, 0])
            scores[:, 0] = torch.where(adopt[:, None], g_s[None, :],
                                       scores[:, 0])
            islands["population"] = pop
            islands["scores"] = scores

        return {"islands": islands, "global_values": g_v, "global_score": g_s}
