"""The batched move library, delta form (counterpart of
`greyjack_tpu/ops/moves.py`; reference `mover.rs`).

Ported so far: the move configuration, the narrow delta sampler that the
random-move local-search path runs (change / swap moves, zero mutation-rate
multiplier, 2-wide deltas) and the delta helpers. The generic
`do_move_delta` / `do_move` samplers wait for ROADMAP Queue 1 item 5
(generic move samplers).

Every function carries a leading island axis I: base candidates f[I, V],
tabu rings [I, G, cap], deltas {"positions": i32[I, P, K],
"values": f[I, P, K], "valid": bool[I, P, K]}. Random numbers come from one
`torch.Generator` per island, so islands draw independent streams.
"""

from __future__ import annotations

import numpy as np
import torch

from greyjack_tpu_torch import config
from greyjack_tpu_torch.ops import selection
from greyjack_tpu_torch.utils.math_utils import round_decimal


def default_move_thresholds():
    """Reference default: six equal probabilities rounded to 3 decimals, the
    remainder folded into the first (`mover.rs:38-49`)."""
    inc = [round_decimal(1.0 / 6.0, 3)] * 6
    inc[0] += 1.0 - sum(inc)
    return np.cumsum(inc)


def thresholds_from_probas(move_probas):
    probas = list(move_probas)
    if len(probas) != 6:
        raise ValueError("move_probas must have 6 entries")
    if abs(sum(probas) - 1.0) >= 1e-6:
        raise ValueError("move_probas must sum to 1.0")
    return np.cumsum(probas)


class MoverConfig:
    """Static (host-side) move configuration (`mover.rs:26-73`) plus the
    delta-path geometry derived from the enabled move set: `delta_width`
    (positions a delta may carry) and `k_sel` (positions the selector
    draws)."""

    def __init__(self, variables_manager, tabu_entity_rate=0.0,
                 mutation_rate_multiplier=None, move_probas=None):
        vm = variables_manager
        self.device = vm.device
        if move_probas is None:
            thr = default_move_thresholds()
            increments = np.diff(np.concatenate([[0.0], thr]))
        else:
            thr = thresholds_from_probas(move_probas)
            increments = np.asarray(move_probas, dtype=np.float64)
        self.thresholds = torch.as_tensor(thr, dtype=torch.float64,
                                          device=self.device)
        self.tabu_entity_rate = float(tabu_entity_rate)
        self.enabled = tuple(i for i in range(6) if increments[i] > 0.0)

        mult = (0.0 if mutation_rate_multiplier is None
                else float(mutation_rate_multiplier))
        self.rates_zero = mult == 0.0
        sizes = np.maximum(vm.group_sizes_np, 1)
        self.group_rates = torch.as_tensor(mult / sizes, dtype=torch.float64,
                                           device=self.device)
        # tabu size per group = max(ceil(rate * len), 1) (`tabu_search_base.rs:91`)
        self.tabu_sizes = torch.as_tensor(
            np.minimum(
                np.maximum(np.ceil(tabu_entity_rate * sizes), 1).astype(np.int32),
                config.MAX_TABU_SIZE,
            ), device=self.device)
        self.use_tabu = tabu_entity_rate > 0.0
        self.n_groups = vm.n_semantic_groups
        self.max_group_size = vm.max_group_size
        self.group_sizes = vm.group_sizes

        km = config.MAX_MOVE_SIZE
        widths = {
            0: 1 if self.rates_zero else km,        # change
            1: 2 if self.rates_zero else km,        # swap
            2: 4 if self.rates_zero else 2 * km,    # swap_edges (pairs)
            3: config.SCRAMBLE_MAX,                 # scramble window
            4: config.DELTA_MOVE_SIZE,              # insertion window cap
            5: config.DELTA_MOVE_SIZE,              # inverse window cap
        }
        sel_needs = {
            0: 1 if self.rates_zero else km,
            1: 2 if self.rates_zero else km,
            2: 2 if self.rates_zero else km,
            3: 0,
            4: 1,
            5: 1,
        }
        self.delta_width = max(widths[i] for i in self.enabled)
        self.k_sel = min(max(max(sel_needs[i] for i in self.enabled), 2), km)

    @property
    def narrow(self):
        """True for the configurations the narrow sampler serves."""
        return (self.rates_zero and set(self.enabled) <= {0, 1}
                and self.delta_width == 2 and self.k_sel == 2)

    def init_tabu_state(self, n_islands):
        cap = min(config.MAX_TABU_SIZE, max(2, self.max_group_size))
        return selection.make_tabu_state(n_islands, max(1, self.n_groups),
                                         cap, self.device)

    def tabu_masks(self, tabu_state):
        """bool[I, G, lmax] masks, built once per step."""
        if not self.use_tabu:
            return None
        return selection.tabu_masks_all(tabu_state, self.tabu_sizes,
                                        self.max_group_size)

    def tabu_free(self, tabu_state):
        """(free_list i32[I, G, Lmax], free_count i32[I, G]): per-group
        non-tabu slot ids, compacted ascending (entries past the count are
        0). Built once per step for every island; the compaction is a sort
        of distinct keys (free slots first), not a scatter."""
        ring = tabu_state["ring"]
        n_isl, g = ring.shape[0], ring.shape[1]
        lmax = self.max_group_size
        slot = torch.arange(lmax, dtype=torch.int32, device=ring.device)
        free = (slot < self.group_sizes[:, None]).expand(n_isl, g, lmax)
        if self.use_tabu:
            free = free & ~selection.tabu_masks_all(
                tabu_state, self.tabu_sizes, lmax)
        cnt = torch.sum(free, dim=-1, dtype=torch.int32)
        order = torch.sort(torch.where(free, slot, lmax + slot),
                           dim=-1).indices.to(torch.int32)
        fl = torch.where(slot < cnt[..., None], order, 0)
        return fl, cnt


def _move_population_delta_narrow(generators, base, n, vm, cfg, free):
    """Neighbourhood sampler for the narrow configs (change / swap only,
    zero mutation-rate multiplier, 2-wide deltas). Each island draws its
    move types, groups and slot pairs from its own generator; the pair is an
    exact uniform draw from the group's tabu-free slot list (`cfg.tabu_free`).
    Move semantics match the JAX package's sampler; the random streams
    differ, so the two agree in distribution only."""
    free_list, free_count = free
    kd = cfg.delta_width
    n_isl = base.shape[0]
    dev = base.device
    n_groups = max(1, cfg.n_groups)
    u, uv, g = [], [], []
    for gen in generators:
        u.append(torch.rand((n, 3), generator=gen, dtype=torch.float32,
                            device=dev))
        uv.append(torch.rand((n, kd), generator=gen, dtype=base.dtype,
                             device=dev))
        g.append(torch.randint(0, n_groups, (n,), generator=gen, device=dev))
    u, uv, g = torch.stack(u), torch.stack(uv), torch.stack(g)
    fc = torch.gather(free_count, 1, g)                       # [I, n]

    if len(cfg.enabled) == 1:
        move_type = torch.full((n_isl, n), cfg.enabled[0], dtype=torch.int32,
                               device=dev)
    else:
        move_type = torch.sum(cfg.thresholds.to(torch.float32) < u[..., :1],
                              dim=-1, dtype=torch.int32)

    # distinct free-slot pair in O(1): a uniform over fc free slots, b over
    # the remaining fc-1 with a shift past a's index
    fc1 = torch.clamp(fc, min=1)
    a_idx = torch.minimum(
        torch.floor(u[..., 1] * fc1.to(torch.float32)).to(torch.int32),
        fc1 - 1)
    fb = torch.clamp(fc - 1, min=1)
    b1 = torch.minimum(
        torch.floor(u[..., 2] * fb.to(torch.float32)).to(torch.int32), fb - 1)
    b_idx = torch.where(fc >= 2, b1 + (b1 >= a_idx).to(torch.int32), a_idx)
    isl = torch.arange(n_isl, device=dev)[:, None, None]
    sel = free_list[isl, g[..., None],
                    torch.stack([a_idx, b_idx], dim=-1).long()]  # [I, n, 2]

    sp = vm.slot_pack[g[..., None], sel.long()]               # [I, n, 2, 4]
    positions = sp[..., 0].to(torch.int32)
    cand_at = torch.gather(base, 1, positions.reshape(n_isl, -1).long()
                           ).reshape(n_isl, n, 2)
    lo_b = sp[..., 1].to(base.dtype)
    hi_b = sp[..., 2].to(base.dtype)
    disc = sp[..., 3] > 0.5

    vals_change = lo_b + uv * (hi_b - lo_b)
    is_swap = (move_type == 1)[..., None]
    values = torch.where(is_swap, cand_at.flip(-1), vals_change)
    jj = torch.arange(kd, device=dev)
    # change touches exactly 1 var, swap exactly 2; a move needs enough
    # free slots (1 / 2) — exact tabu semantics
    valid = torch.where(is_swap, fc[..., None] >= 2,
                        (jj < 1) & (fc[..., None] >= 1))
    values = torch.clamp(values, lo_b, hi_b)
    values = torch.where(disc, torch.round(values), values)

    info = {"group": g.to(torch.int32), "positions": sel,
            "count": torch.where(move_type == 1, 2, 1).to(torch.int32)}
    return ({"positions": positions, "values": values, "valid": valid},
            info)


def move_population_delta(generators, base, n_neighbours, vm, cfg,
                          tabu_state, free=None):
    """n_neighbours independent delta moves off each island's base
    candidate f[I, V]. `free` optionally supplies a precomputed
    `cfg.tabu_free` pair (the island runner's prestep builds it once per
    step for all islands)."""
    if not cfg.narrow:
        raise NotImplementedError(
            "only the narrow change/swap delta sampler is ported; the "
            "generic do_move_delta sampler is ROADMAP Queue 1 item 5")
    if free is None:
        free = cfg.tabu_free(tabu_state)
    return _move_population_delta_narrow(generators, base, n_neighbours, vm,
                                         cfg, free)


def dedupe_delta(delta):
    """Mask out later duplicates of the same position (their values are
    equal, so dropping them is exact). Works over any leading axes."""
    pos = delta["positions"]
    k = pos.shape[-1]
    idx = torch.arange(k, device=pos.device)
    eq = ((pos[..., :, None] == pos[..., None, :])
          & delta["valid"][..., :, None] & delta["valid"][..., None, :])
    earlier_dup = torch.any(eq & (idx[None, :] < idx[:, None]), dim=-1)
    return {**delta, "valid": delta["valid"] & ~earlier_dup}


def apply_delta(base, delta):
    """Materialize one delta per island: base f[I, V], delta leaves [I, K].
    Later delta entries win on position collisions. Narrow deltas only
    (K <= 8); the wide sweep-winner branch is not ported yet."""
    kd = delta["positions"].shape[-1]
    if kd > 8:
        raise NotImplementedError("apply_delta for wide (K > 8) deltas is "
                                  "not ported yet")
    iota = torch.arange(base.shape[-1], dtype=torch.int32, device=base.device)
    out = base
    for k in range(kd):
        m = delta["valid"][:, k, None] & (iota == delta["positions"][:, k, None])
        out = torch.where(m, delta["values"][:, k, None].to(base.dtype), out)
    return out


def take_one(tree, idx):
    """Row `idx[i]` of every leaf's neighbour axis, per island: leaves
    [I, P, ...], idx int[I] -> leaves [I, ...]."""
    def sel(x):
        return x[torch.arange(x.shape[0], device=x.device), idx]
    if isinstance(tree, dict):
        return {k: sel(v) for k, v in tree.items()}
    return sel(tree)


def update_tabu_from_info(tabu_state, info, sample_idx, active=None):
    """Push each island's chosen candidate's touched slots into its group
    ring. `active=False` freezes an island's ring exactly (count 0 writes
    nothing and leaves the cursor in place)."""
    row = take_one(info, sample_idx)
    count = row["count"]
    if active is not None:
        count = torch.where(active, count, 0)
    return selection.tabu_push(tabu_state, row["group"], row["positions"],
                               count)
