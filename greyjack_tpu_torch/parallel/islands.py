"""Island-model runner on one device (counterpart of
`greyjack_tpu/parallel/islands.py`; reference `solver.rs:85-143`,
`agent_base.rs:124-188`).

Islands are a leading tensor axis [I, ...]; one chunk advances every island
`n_steps` steps (a Python loop), then runs ring migration (`torch.roll` by
one: island i receives from island i-1), the lexicographic global-best
reduce with adoption, and the per-chunk `refresh`. Dead islands are frozen
by their step budget but keep relaying. Ported: the LocalSearch arm; the
Population and LateAcceptance arms and multi-device meshes raise.
"""

from __future__ import annotations

import torch

from greyjack_tpu_torch.agents import base as agent_base
from greyjack_tpu_torch.ops import lexico


class IslandRunner:
    def __init__(self, kernel, n_islands, migration_frequency, mesh=None,
                 compare_to_global=True):
        if mesh is not None:
            raise NotImplementedError(
                "multi-device islands are not ported yet (ROADMAP Queue 1 "
                "item 9)")
        if kernel.metaheuristic_kind != "LocalSearch":
            raise NotImplementedError(
                f"{kernel.metaheuristic_kind} islands are not ported yet "
                "(ROADMAP Queue 1 item 7)")
        self.kernel = kernel
        self.n_islands = int(n_islands)
        self.migration_frequency = int(migration_frequency)
        self.compare_to_global = compare_to_global
        self.kind = kernel.metaheuristic_kind

    def init(self, generators):
        """Initial run state from one generator per island."""
        if len(generators) != self.n_islands:
            raise ValueError("need one generator per island")
        islands = self.kernel.init_state(generators)
        if "late" in islands:
            raise NotImplementedError(
                "LateAcceptance islands are not ported yet")
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
        stays exact)."""
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
        for i in range(n_steps):
            act = alive & (i < steps_left)
            ex = dict(extras, _active=act)
            if self.kernel.prestep is not None:
                ex.update(self.kernel.prestep(islands))
            # the step freezes inactive islands itself (self-gating)
            islands = step(generators, islands, ex)
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
        """Ring exchange + acceptance (`agent_base.rs:322-444`), LocalSearch
        arm: each island takes its ring predecessor's individual when it is
        no worse."""
        pop = islands["population"]                           # [I, 1, V]
        scores = islands["scores"]                            # [I, 1, S]
        mig_v = torch.roll(pop[:, 0], 1, dims=0)
        mig_s = torch.roll(scores[:, 0], 1, dims=0)
        accept = lexico.lex_leq(mig_s, scores[:, 0])
        pop = pop.clone()
        scores = scores.clone()
        pop[:, 0] = torch.where(accept[:, None], mig_v, pop[:, 0])
        scores[:, 0] = torch.where(accept[:, None], mig_s, scores[:, 0])
        islands = dict(islands)
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

        if self.compare_to_global:
            # adopt the global best where strictly better than the island top
            adopt = lexico.lex_less(g_s, islands["top_score"])  # [I]
            pop = islands["population"].clone()
            scores = islands["scores"].clone()
            pop[:, 0] = torch.where(adopt[:, None], g_v[None, :], pop[:, 0])
            scores[:, 0] = torch.where(adopt[:, None], g_s[None, :],
                                       scores[:, 0])
            islands = dict(islands)
            islands["population"] = pop
            islands["scores"] = scores

        return {"islands": islands, "global_values": g_v, "global_score": g_s}
