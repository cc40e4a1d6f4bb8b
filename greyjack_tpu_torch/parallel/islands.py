"""Island-model runner (counterpart of
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
then a re-sort; no adoption of the global best).

Under a mesh (`parallel/mesh.py`: one process per device over
`torch.distributed`), rank r owns the global islands [r·n_local,
(r+1)·n_local) and steps them with the same local code. The ring closes
across ranks: each rank shifts its islands by one and its first island
takes the last island of rank r-1, whose boundary rows come in one
`all_gather` of each rank's last row (only the migrants' population and
score rows cross, never the state). The global best is an `all_gather` of
the island tops in global island order, then the same reduce, so ties
break as on one device. Every island draws from its own generator, so a
run whose ranks hold the generators of their global islands equals the
single-device run bit for bit.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from greyjack_tpu_torch.agents import base as agent_base
from greyjack_tpu_torch.agents import late_acceptance as la_mod
from greyjack_tpu_torch.ops import lexico


def _leaves(tree, prefix=()):
    """[(path, tensor)] of a nested dict of tensors, in its key order."""
    out = []
    for key, value in tree.items():
        if isinstance(value, dict):
            out += _leaves(value, prefix + (key,))
        else:
            out.append((prefix + (key,), value))
    return out


def _set_leaf(tree, path, value):
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def gather_rows(mesh, tensors):
    """All-gather `tensors` (any dtypes, the same shapes on every rank)
    over the mesh's island group in one collective: each rank's tensors
    travel as the bytes of one uint8 buffer, so every dtype (bool, int8,
    f64) arrives bit-exact on NCCL and gloo alike. Returns, for each rank
    in group order, the list of its tensors."""
    flat = [t.contiguous().reshape(-1).view(torch.uint8) for t in tensors]
    buf = torch.cat(flat)
    out = [torch.empty_like(buf) for _ in range(mesh.size)]
    dist.all_gather(out, buf, group=mesh.group)
    ranks = []
    for got in out:
        parts, off = [], 0
        for t, f in zip(tensors, flat):
            parts.append(got[off:off + f.numel()].clone().view(t.dtype)
                         .reshape(t.shape))
            off += f.numel()
        ranks.append(parts)
    return ranks


def gather_cat(mesh, tensors):
    """For each of `tensors` (leading island axis), every rank's rows in
    rank order: the global island axis."""
    ranks = gather_rows(mesh, tensors)
    return [torch.cat([r[i] for r in ranks], dim=0)
            for i in range(len(tensors))]


class IslandRunner:
    def __init__(self, kernel, n_islands, migration_frequency, mesh=None,
                 compare_to_global=True):
        self.kernel = kernel
        self.n_islands = int(n_islands)
        self.migration_frequency = int(migration_frequency)
        self.mesh = mesh
        self.compare_to_global = compare_to_global
        self.n_local = self.n_islands
        self.offset = 0
        if mesh is not None:
            if self.n_islands % mesh.size != 0:
                raise ValueError(
                    f"n_islands={self.n_islands} must divide evenly over the "
                    f"{mesh.size}-device islands mesh axis")
            self.n_local = self.n_islands // mesh.size
            self.offset = mesh.index * self.n_local
        self.kind = kernel.metaheuristic_kind
        if self.kind == "Population":
            self.migrants_count = max(
                1, math.ceil(kernel.migration_rate * kernel.population_size))
        else:
            self.migrants_count = 1

    @property
    def local_islands(self):
        """The slice of global island ids this rank owns (all of them
        without a mesh)."""
        return slice(self.offset, self.offset + self.n_local)

    def init(self, generators):
        """Initial run state from one generator per island (under a mesh,
        per local island: the generators of this rank's global islands)."""
        if len(generators) != self.n_local:
            raise ValueError("need one generator per (local) island")
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
        (the per-step SA auto-temperature, `agent_base.rs:537-552`).
        Under a mesh `alive`, `steps_left` and `extras` still cover all I
        islands (every rank holds them whole) and `generators` are the
        local islands'."""
        if steps_left is None:
            steps_left = torch.full(alive.shape, n_steps, dtype=torch.int32,
                                    device=alive.device)
        if self.mesh is not None:
            own = self.local_islands
            alive, steps_left = alive[own], steps_left[own]
            extras = {k: v[own] for k, v in extras.items()}
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

    def _ring(self, *xs):
        """Each island's ring predecessor's rows of `xs` (leading island
        axis): island i receives from island i-1. On one device a roll;
        under a mesh a local shift whose first row is the previous rank's
        last (`greyjack_tpu/parallel/islands.py:197-205`)."""
        if self.mesh is None:
            return [torch.roll(x, 1, dims=0) for x in xs]
        prev = gather_rows(self.mesh, [x[-1:] for x in xs])[
            (self.mesh.index - 1) % self.mesh.size]
        return [torch.cat([p, x[:-1]], dim=0) for p, x in zip(prev, xs)]

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
        mig_v, mig_s = self._ring(pop[:, :k], scores[:, :k])
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
        mig_v, mig_s = self._ring(pop[:, 0], scores[:, 0])
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
        if self.mesh is not None:
            # every rank's tops in global island order
            # (`greyjack_tpu/parallel/islands.py:209-213`)
            tops_v, tops_s = gather_cat(self.mesh, [tops_v, tops_s])
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

    # --- the host's view under a mesh ---------------------------------------
    def gather_islands(self, islands, keys):
        """{key: tensor [I, ...]} of the island leaves `keys`, every rank's
        local islands in global island order (on one device, the leaves
        themselves)."""
        leaves = [islands[key] for key in keys]
        if self.mesh is not None:
            leaves = gather_cat(self.mesh, leaves)
        return dict(zip(keys, leaves))

    def gather_state(self, state, generators):
        """(the whole run state with all I islands, every island's
        generator state) on every rank, for a checkpoint: one collective
        of every island leaf and this rank's generator states."""
        gen_states = [g.get_state() for g in generators]
        if self.mesh is None:
            return state, gen_states
        leaves = _leaves(state["islands"])
        gens = torch.stack(gen_states).to(self.mesh.device)
        *whole, all_gens = gather_cat(self.mesh,
                                      [t for _, t in leaves] + [gens])
        islands = {}
        for (path, _), leaf in zip(leaves, whole):
            _set_leaf(islands, path, leaf)
        return {**state, "islands": islands}, list(all_gens.cpu())

    def local_state(self, state):
        """This rank's part of a whole run state (all I islands): its
        islands' leaves, the replicated global best as is."""
        if self.mesh is None:
            return state
        own = self.local_islands

        def cut(tree):
            return {k: cut(v) if isinstance(v, dict) else v[own]
                    for k, v in tree.items()}

        return {**state, "islands": cut(state["islands"])}
