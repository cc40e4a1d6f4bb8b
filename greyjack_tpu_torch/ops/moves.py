"""The batched move library (counterpart of `greyjack_tpu/ops/moves.py`;
reference `mover.rs`): six move types (change, swap, swap_edges, scramble,
insertion, inverse) drawn by cumulative probability thresholds on a random
semantic group, with per-group entity tabu and a Binomial change count.

Two forms: `move_population` moves whole candidates f[I, P, V] (the plain,
full-rescore path), `move_population_delta` emits each move as a delta of
the changed positions against one base per island (the delta path). The
narrow delta sampler serves change / swap moves at a zero mutation-rate
multiplier; every other configuration runs the generic one.

Each generic sampler is a draw and a deterministic body. The draw takes
one f64 `torch.rand` per island, of every leaf's width packed together,
and turns its columns into the leaves (f64 / f32 uniforms, Gumbels,
integers, Bernoullis, Binomial counts). The body (`do_move`,
`do_move_delta`) is a function of those leaves that gives, bit for bit,
what the JAX function gives for the same noise; only the random streams
differ between the packages.

Every function carries a leading island axis I: candidates f[I, P, V] or
bases f[I, V], tabu rings [I, G, cap], deltas {"positions": i32[I, P, K],
"values": f[I, P, K], "valid": bool[I, P, K]}. Random numbers come from one
`torch.Generator` per island, so islands draw independent streams.
"""

from __future__ import annotations

import numpy as np
import torch

from greyjack_tpu_torch import config
from greyjack_tpu_torch.ops import move_kernel, selection
from greyjack_tpu_torch.utils.math_utils import round_decimal
from greyjack_tpu_torch.utils.tracing import span


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


# --- noise draws -------------------------------------------------------------

_GRID24 = 2.0 ** 24


def uniform_f32(u):
    """f64 uniforms of [0, 1) -> f32 uniforms on the 2^-24 grid of [0, 1)
    (exact: the value is rounded down to the grid, never up to 1.0)."""
    return (torch.floor(u * _GRID24) / _GRID24).to(torch.float32)


def gumbel_f32(u32):
    """f32 Gumbels -log(-log(u)) of f32 uniforms, u = 0 raised to the
    smallest normal as `jax.random.gumbel` does."""
    tiny = torch.finfo(torch.float32).tiny
    return -torch.log(-torch.log(torch.clamp(u32, min=tiny)))


def uniform_ints(u, lo, hi):
    """int32 uniforms of [lo, hi) from f64 uniforms of [0, 1)."""
    n = hi - lo
    return (torch.clamp(torch.floor(u * n), max=n - 1) + lo).to(torch.int32)


def binomial_counts(u32, rate):
    """int32[...]: Binomial(V, rate) change counts (`mover.rs:130-143`) —
    how many of the f32 uniforms u32[..., V] fall below the f32 rate
    (`greyjack_tpu/ops/moves.py:210-213`)."""
    return torch.sum(u32 < rate.to(torch.float32)[..., None], dim=-1,
                     dtype=torch.int32)


def island_uniforms(generators, shape, device):
    """f64[I, *shape] uniforms of [0, 1): one `torch.rand` per island, from
    its own generator — the one place the generic samplers draw."""
    return torch.stack([torch.rand(shape, generator=g, dtype=torch.float64,
                                   device=device) for g in generators])


def field_columns(fields):
    """[(name, first column, columns, kind, arg)] of the leaves `fields`
    ((name, width, kind, arg); width None for a scalar leaf) packed in
    order into one draw."""
    out, col = [], 0
    for name, w, kind, arg in fields:
        out.append((name, col, w or 1, kind, arg))
        col += w or 1
    return out


def draw_uniforms(generators, n, fields, device):
    """f64[I, n, W]: the uniforms of n draws of `fields` an island, every
    leaf's columns packed as `field_columns` lays them out."""
    width = sum(c[2] for c in field_columns(fields))
    return island_uniforms(generators, (n, width), device)


def noise_leaves(u, fields, cfg, dtype):
    """The noise leaves {name: [I, n, ...]} of `fields` from their packed
    uniforms u f64[I, n, W]: each leaf's columns transformed by its
    kind."""
    out = {}
    for (name, w, kind, arg), (_, col, width, _, _) in zip(
            fields, field_columns(fields)):
        x = u[..., col:col + width]
        if w is None:
            x = x[..., 0]
        if kind == "f64" or (kind == "dtype" and dtype == torch.float64):
            out[name] = x
        elif kind in ("f32", "dtype"):
            out[name] = uniform_f32(x)
        elif kind == "gumbel":
            out[name] = gumbel_f32(uniform_f32(x))
        elif kind == "int":
            out[name] = uniform_ints(x, *arg)
        elif kind == "bernoulli":
            out[name] = uniform_f32(x) < arg
        elif kind == "count":
            out[name] = binomial_counts(
                uniform_f32(x), cfg.group_rates[out["g"].long()])
    if "c_raw" not in out:
        # a zero rate never passes `u < rate`: no draw needed
        out["c_raw"] = torch.zeros(u.shape[:2], dtype=torch.int32,
                                   device=u.device)
    return out


def _draw(generators, n, fields, vm, cfg, dtype):
    """The noise leaves of n draws of `fields` an island: one f64
    `torch.rand` per island of all widths packed, then each leaf's
    columns transformed by its kind."""
    return noise_leaves(draw_uniforms(generators, n, fields, vm.device),
                        fields, cfg, dtype)


def _group_fields(vm, cfg):
    fields = [("g", None, "int", (0, max(1, cfg.n_groups)))]
    if not cfg.rates_zero:
        fields.append(("c_raw", vm.variables_count, "count", None))
    return fields


def move_noise_fields(vm, cfg):
    """(name, width, kind, arg) of the leaves `do_move` takes, in the
    layout of the JAX function's key split (`moves.py:198-234`): u_move
    f64, g / c_raw / k_scr i32, gumbel f32[lmax], u_start f32,
    perm_gumbel f32[SCRAMBLE_MAX], u_res [MAX_MOVE_SIZE] of the rows'
    dtype."""
    return ([("u_move", None, "f64", None)] + _group_fields(vm, cfg)
            + [("gumbel", cfg.max_group_size, "gumbel", None),
               ("k_scr", None, "int",
                (config.SCRAMBLE_MIN, config.SCRAMBLE_MAX + 1)),
               ("u_start", None, "f32", None),
               ("perm_gumbel", config.SCRAMBLE_MAX, "gumbel", None),
               ("u_res", config.MAX_MOVE_SIZE, "dtype", None)])


def draw_move_noise(generators, n, vm, cfg, dtype):
    """The leaves `do_move` takes, for n candidates an island."""
    return _draw(generators, n, move_noise_fields(vm, cfg), vm, cfg, dtype)


def delta_noise_fields(vm, cfg):
    """(name, width, kind, arg) of the leaves `do_move_delta` takes for
    this configuration: only those of enabled moves
    (`moves.py:346-486`)."""
    enabled = set(cfg.enabled)
    kd = cfg.delta_width
    fields = []
    if len(cfg.enabled) > 1:
        fields.append(("u_move", None, "f64", None))
    fields += _group_fields(vm, cfg)
    if cfg.k_sel == 2:
        attempts = 4 if cfg.use_tabu else 1
        fields += [("u_a", attempts, "f32", None),
                   ("u_b", attempts, "f32", None)]
    else:
        fields.append(("gumbel", cfg.max_group_size, "gumbel", None))
    if 3 in enabled:
        fields += [("k_scr", None, "int",
                    (config.SCRAMBLE_MIN, config.SCRAMBLE_MAX + 1)),
                   ("u_start", None, "f32", None),
                   ("perm_gumbel", config.SCRAMBLE_MAX, "gumbel", None)]
    if {4, 5} & enabled:
        fields += [("off", None, "int", (1, kd)),
                   ("sign", None, "bernoulli", 0.5)]
    if 0 in enabled:
        fields.append(("u_res", kd, "dtype", None))
    return fields


def draw_delta_noise(generators, n, vm, cfg, dtype):
    """The leaves `do_move_delta` takes, for n neighbours an island."""
    return _draw(generators, n, delta_noise_fields(vm, cfg), vm, cfg, dtype)


# --- deterministic bodies ----------------------------------------------------

def _counts(c_raw, length, kmax_change, kmax_edges):
    """(c_change, c_swap, c_edges) of the clipped Binomial count."""
    c_change = torch.clamp(torch.clamp(c_raw, min=1), max=kmax_change)
    c_swap = torch.clamp(torch.clamp(c_raw, min=2), max=kmax_change)
    edges_hi = torch.clamp(torch.clamp(length - 1, max=kmax_edges), min=2)
    c_edges = torch.minimum(torch.clamp(c_raw, min=2), edges_hi)
    return c_change, c_swap, c_edges


def _tabu_info(move_type, g, sel, start, c_change, c_swap, c_edges):
    """The touched group, slots and count of each move, for the tabu push:
    a scramble pushes its window start once."""
    positions = torch.where((move_type == 3)[..., None],
                            start[..., None].expand(sel.shape), sel)
    one = torch.ones_like(c_change)
    per_type = torch.stack([c_change, c_swap, c_edges, one, 2 * one,
                            2 * one], dim=-1)
    # a draw above the last threshold (move type 6) reads the last entry,
    # as JAX's clamped gather does
    count = torch.where(move_type == 3, one, torch.gather(
        per_type, -1, torch.clamp(move_type, max=5).long()[..., None])[..., 0])
    return {"group": g.to(torch.int32), "positions": positions.to(torch.int32),
            "count": count.to(torch.int32)}


def _mswap(p, a, b, enable):
    """Swap p[..., a] <-> p[..., b] in place where `enable`: p[a] is
    written first, then p[b], so a == b is an identity."""
    ai, bi = a.long()[..., None], b.long()[..., None]
    va, vb = torch.gather(p, -1, ai), torch.gather(p, -1, bi)
    en = enable[..., None]
    p.scatter_(-1, ai, torch.where(en, vb, va))
    p.scatter_(-1, bi, torch.where(en, va, vb))


def do_move(candidates, noise, vm, cfg, tabu_masks):
    """One move on each candidate f[I, P, V] from the noise leaves of
    `draw_move_noise` ([I, P, ...]); `tabu_masks` bool[I, G, lmax] or None.
    Returns (moved f[I, P, V], info {"group", "positions" i32[I, P, 8],
    "count"}) — bit-equal to `greyjack_tpu/ops/moves.py:187-315` fed the
    same noise.

    Every move is a permutation p of the candidate's positions (then
    moved = candidates[p]) followed by the change move's resampling.
    Targets a move leaves alone go to a sentinel column V of p and of the
    resampled row, which is dropped, so no two live writes share an
    index. Branches of moves with probability 0 are skipped: no candidate
    can draw them."""
    n_isl, n, v = candidates.shape
    dev = candidates.device
    enabled = set(cfg.enabled)
    k_max = config.MAX_MOVE_SIZE
    lmax = cfg.max_group_size
    members = vm.group_members
    ii = torch.arange(k_max, dtype=torch.int32, device=dev)

    move_type = torch.sum(cfg.thresholds < noise["u_move"][..., None],
                          dim=-1, dtype=torch.int32)
    g = noise["g"].long()
    gk = g[..., None]
    length = cfg.group_sizes[g].to(torch.int32)
    c_change, c_swap, c_edges = _counts(noise["c_raw"], length, k_max, k_max)
    k_scr = noise["k_scr"]

    sel_limit = torch.where(move_type == 2, length - 1, length)
    tabu_mask = None
    if cfg.use_tabu and tabu_masks is not None:
        tabu_mask = selection.tabu_mask_row(tabu_masks, g)
    sel = selection.gumbel_topk_positions(noise["gumbel"], sel_limit, k_max,
                                          tabu_mask)
    start_limit = torch.clamp(length - k_scr, min=1)
    start = torch.floor(noise["u_start"] * start_limit.to(torch.float32)).to(
        torch.int32)
    sel_vars = members[gk, sel.long()]                          # [I, P, 8]

    p = torch.arange(v + 1, device=dev).expand(n_isl, n, v + 1).clone()

    def put(tgt, src):
        p.scatter_(-1, tgt.long(), src.long())

    if 1 in enabled:  # swap: left-rotate the values at the selected vars
        en1 = (move_type == 1) & (length >= c_swap)
        tgt1 = torch.where(en1[..., None] & (ii < c_swap[..., None]),
                           sel_vars, v)
        rot = torch.remainder(ii + 1, torch.clamp(c_swap, min=1)[..., None])
        put(tgt1, torch.gather(sel_vars, -1, rot.long()))
    if 2 in enabled:  # swap_edges: the sequential swap composition
        en2 = (move_type == 2) & (length >= 3)
        sel_next = members[gk, torch.clamp(sel + 1, max=lmax - 1).long()]
        cm = torch.clamp(c_edges, min=1)[..., None]
        for i in range(1, k_max):
            en = en2 & (i < c_edges)
            prev_i = torch.remainder(torch.full_like(cm, i), cm).long()
            cur_i = torch.remainder(torch.full_like(cm, i + 1), cm).long()
            for row in (sel_vars, sel_next):
                _mswap(p, torch.gather(row, -1, prev_i)[..., 0],
                       torch.gather(row, -1, cur_i)[..., 0], en)
    if 3 in enabled:  # scramble: a random permutation of the window
        en3 = (move_type == 3) & (length > k_scr)
        jj = torch.arange(config.SCRAMBLE_MAX, dtype=torch.int32, device=dev)
        # dynamic_slice clamps its start so that the window fits
        w_start = torch.clamp(start, 0, max(lmax - config.SCRAMBLE_MAX, 0))
        w_vars = members[gk, torch.clamp(w_start[..., None] + jj,
                                         max=lmax - 1).long()]
        perm = selection.random_permutation_positions(noise["perm_gumbel"],
                                                      k_scr)
        put(torch.where(en3[..., None] & (jj < k_scr[..., None]), w_vars, v),
            torch.gather(w_vars, -1, perm.long()))
    if {4, 5} & enabled:  # subrange rotation / reversal of the member row
        a, b = sel[..., 0], sel[..., 1]
        en45 = (((move_type == 4) | (move_type == 5)) & (length > 1)
                & (a != b))
        lo = torch.minimum(a, b)[..., None]
        hi = torch.maximum(a, b)[..., None]
        row = members[g]                                      # [I, P, lmax]
        idxl = torch.arange(lmax, dtype=torch.int32, device=dev)
        in_range = (idxl >= lo) & (idxl <= hi)
        src = None
        if 4 in enabled:
            m_lo = torch.gather(row, -1, lo.long())
            m_hi = torch.gather(row, -1, hi.long())
            src = torch.where(
                (a < b)[..., None],
                torch.where(idxl == hi, m_lo, torch.roll(row, -1, dims=-1)),
                torch.where(idxl == lo, m_hi, torch.roll(row, 1, dims=-1)))
        if 5 in enabled:
            # roll(flip(row), lo + hi - (lmax - 1)) as index arithmetic
            shift = lo + hi - (lmax - 1)
            rev = torch.gather(row, -1, (lmax - 1 - torch.remainder(
                idxl - shift, lmax)).long())
            src = rev if src is None else torch.where(
                (move_type == 4)[..., None], src, rev)
        put(torch.where(en45[..., None] & in_range, row, v), src)

    moved = torch.gather(candidates, -1, p[..., :v])
    if 0 in enabled:  # change: resample U[lb, ub) at the selected vars
        dt = candidates.dtype
        lo_b = vm.lower_bounds[sel_vars.long()].to(dt)
        hi_b = vm.upper_bounds[sel_vars.long()].to(dt)
        rnd = lo_b + noise["u_res"] * (hi_b - lo_b)
        en0 = (move_type == 0) & (length >= c_change)
        tgt0 = torch.where(en0[..., None] & (ii < c_change[..., None]),
                           sel_vars, v)
        moved = torch.cat([moved, moved[..., :1]], dim=-1)
        moved.scatter_(-1, tgt0.long(), rnd)
        moved = moved[..., :v]
    info = _tabu_info(move_type, g, sel, start, c_change, c_swap, c_edges)
    return moved, info


def _pad_to(x, kd):
    if x.shape[-1] >= kd:
        return x[..., :kd]
    return torch.cat([x, torch.zeros(x.shape[:-1] + (kd - x.shape[-1],),
                                     dtype=x.dtype, device=x.device)], -1)


def do_move_delta(base, noise, vm, cfg, tabu_masks):
    """One move per neighbour off each island's base f[I, V], in delta form,
    from the leaves of `draw_delta_noise` ([I, n, ...]); `tabu_masks`
    bool[I, G, lmax] or None. Returns (delta leaves [I, n, KD], info) —
    bit-equal to `greyjack_tpu/ops/moves.py:318-518` fed the same noise.
    Disabled moves are pruned; positions come from `sample_distinct_pair`
    when k_sel == 2, else from a Gumbel top-k. Insertion / inverse windows
    are capped at KD - 1 (b = a ± U{1..KD-1})."""
    kd, ks = cfg.delta_width, cfg.k_sel
    enabled = set(cfg.enabled)
    lmax = cfg.max_group_size
    members = vm.group_members
    n_isl = base.shape[0]
    dev = base.device
    lead = noise["g"].shape
    k_max = config.MAX_MOVE_SIZE
    jj = torch.arange(kd, dtype=torch.int32, device=dev)

    if len(cfg.enabled) == 1:
        move_type = torch.full(lead, cfg.enabled[0], dtype=torch.int32,
                               device=dev)
    else:
        move_type = torch.sum(cfg.thresholds < noise["u_move"][..., None],
                              dim=-1, dtype=torch.int32)
    g = noise["g"].long()
    gk = g[..., None]
    length = cfg.group_sizes[g].to(torch.int32)
    c_change, c_swap, c_edges = _counts(noise["c_raw"], length,
                                        min(k_max, kd), ks)

    sel_limit = (torch.where(move_type == 2, length - 1, length)
                 if 2 in enabled else length)
    if ks == 2:
        masks2 = tabu_masks if (cfg.use_tabu and tabu_masks is not None) \
            else None
        sel = selection.sample_distinct_pair(noise["u_a"], noise["u_b"],
                                             sel_limit, masks2, g)
    else:
        tabu_mask = None
        if cfg.use_tabu and tabu_masks is not None:
            tabu_mask = selection.tabu_mask_row(tabu_masks, g)
        sel = selection.gumbel_topk_positions(noise["gumbel"], sel_limit, ks,
                                              tabu_mask)
    sel_vars = members[gk, sel.long()]

    def padded_row(idx):
        # the member row padded with its last slot for window slices
        return members[gk, torch.clamp(idx, max=lmax - 1).long()]

    positions = torch.zeros(lead + (kd,), dtype=torch.int32, device=dev)
    if 0 in enabled or 1 in enabled:
        pad_sel = _pad_to(sel_vars, kd)
        if len(cfg.enabled) > 1:
            is01 = (move_type == 0) | (move_type == 1)
            positions = torch.where(is01[..., None], pad_sel, positions)
        else:
            positions = pad_sel
    if 2 in enabled:
        sel_next = members[gk, torch.clamp(sel + 1, max=lmax - 1).long()]
        pos2 = _pad_to(torch.cat([sel_vars, sel_next], dim=-1), kd)
        positions = torch.where((move_type == 2)[..., None], pos2, positions)
    zero = torch.zeros(lead, dtype=torch.int32, device=dev)
    k_scr = start = zero
    if 3 in enabled:
        k_scr = noise["k_scr"]
        start_limit = torch.clamp(length - k_scr, min=1)
        start = torch.floor(noise["u_start"]
                            * start_limit.to(torch.float32)).to(torch.int32)
        w_start = torch.clamp(start, 0, lmax + kd - config.SCRAMBLE_MAX)
        w_vars = padded_row(w_start[..., None] + torch.arange(
            config.SCRAMBLE_MAX, dtype=torch.int32, device=dev))
        positions = torch.where((move_type == 3)[..., None],
                                _pad_to(w_vars, kd), positions)
    a = b = r = zero
    if {4, 5} & enabled:
        a = sel[..., 0]
        off = noise["off"]
        b = torch.where(noise["sign"], a + off, a - off)
        b = torch.minimum(torch.clamp(b, min=0), length - 1)
        lo = torch.minimum(a, b)
        r = torch.abs(a - b)          # inclusive window [lo, lo + r]
        wm = padded_row(torch.clamp(lo, 0, lmax)[..., None] + jj)
        is45 = (move_type == 4) | (move_type == 5)
        positions = torch.where(is45[..., None], wm, positions)

    cand_at = torch.gather(base, 1, positions.reshape(n_isl, -1).long()
                           ).reshape(positions.shape)
    bp = vm.bounds_pack[positions.long()]
    lo_b = bp[..., 0].to(base.dtype)
    hi_b = bp[..., 1].to(base.dtype)
    disc = bp[..., 2] > 0.5

    def col(x):
        return x[..., None]

    branch_vals = []  # (move, values [.., kd], valid [.., kd])
    if 0 in enabled:
        vals0 = lo_b + noise["u_res"] * (hi_b - lo_b)
        branch_vals.append((0, vals0, (jj < col(c_change))
                            & col(length >= c_change)))
    if 1 in enabled:
        rot = torch.remainder(jj + 1, col(torch.clamp(c_swap, min=1)))
        branch_vals.append((1, torch.gather(cand_at, -1, rot.long()),
                            (jj < col(c_swap)) & col(length >= c_swap)))
    if 2 in enabled:
        vals2 = cand_at
        cm = col(torch.clamp(c_edges, min=1))
        for i in range(1, ks):
            en = col(i < c_edges)
            prev_i = torch.remainder(torch.full_like(cm, i), cm)
            cur_i = torch.remainder(torch.full_like(cm, i + 1), cm)
            for xa, xb in ((prev_i, cur_i), (prev_i + ks, cur_i + ks)):
                x = torch.gather(positions, -1,
                                 torch.clamp(xa, max=kd - 1).long())
                y = torch.gather(positions, -1,
                                 torch.clamp(xb, max=kd - 1).long())
                ix = torch.argmax((positions == x).to(torch.int32), -1, True)
                iy = torch.argmax((positions == y).to(torch.int32), -1, True)
                vx = torch.gather(vals2, -1, ix)
                vy = torch.gather(vals2, -1, iy)
                swap_to = torch.where(positions == x, vy,
                                      torch.where(positions == y, vx, vals2))
                vals2 = torch.where(en, swap_to, vals2)
        valid2 = ((torch.where(jj < ks, jj, jj - ks) < col(c_edges))
                  & (jj < 2 * ks) & col(length >= 3))
        branch_vals.append((2, vals2, valid2))
    if 3 in enabled:
        perm = selection.random_permutation_positions(noise["perm_gumbel"],
                                                      k_scr)
        rest = torch.arange(config.SCRAMBLE_MAX, kd, dtype=torch.int32,
                            device=dev).expand(lead + (kd - config.SCRAMBLE_MAX,))
        perm_kd = torch.cat([perm, rest], dim=-1)
        branch_vals.append((3, torch.gather(cand_at, -1, perm_kd.long()),
                            (jj < col(k_scr)) & col(length > k_scr)))
    live45 = col((length > 1) & (r != 0))
    if 4 in enabled:  # rotation of [0, r]: left when a < b, right when a > b
        src_left = torch.where(jj == col(r), 0, torch.clamp(jj + 1, max=kd - 1))
        src_right = torch.where(jj == 0, col(r), torch.clamp(jj - 1, min=0))
        src4 = torch.where(col(a < b), src_left, src_right)
        branch_vals.append((4, torch.gather(cand_at, -1, src4.long()),
                            (jj <= col(r)) & live45))
    if 5 in enabled:  # reversal of [0, r]
        src5 = torch.clamp(col(r) - jj, 0, kd - 1)
        branch_vals.append((5, torch.gather(cand_at, -1, src5.long()),
                            (jj <= col(r)) & live45))

    values, valid = branch_vals[-1][1], branch_vals[-1][2]
    for idx, vals, vld in reversed(branch_vals[:-1]):
        this = col(move_type == idx)
        values = torch.where(this, vals, values)
        valid = torch.where(this, vld, valid)

    # per-target fix: clamp, then round-half-even for discrete targets
    values = torch.minimum(torch.maximum(values, lo_b), hi_b)
    values = torch.where(disc, torch.round(values), values)
    info = _tabu_info(move_type, g, sel, start, c_change, c_swap, c_edges)
    return ({"positions": positions, "values": values, "valid": valid},
            info)


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
    `cfg.tabu_free` pair for the narrow sampler (the island runner's
    prestep builds it once per step for all islands); the generic sampler
    reads the tabu masks instead."""
    with span("gj.moves.sample"):
        if not cfg.narrow:
            noise = draw_delta_noise(generators, n_neighbours, vm, cfg,
                                     base.dtype)
            return do_move_delta(base, noise, vm, cfg,
                                 cfg.tabu_masks(tabu_state))
        if free is None:
            free = cfg.tabu_free(tabu_state)
        return _move_population_delta_narrow(generators, base, n_neighbours,
                                             vm, cfg, free)


def move_population(generators, population, vm, cfg, tabu_state):
    """One random move on every candidate of population f[I, P, V]
    (`greyjack_tpu/ops/moves.py:668-681`), fixed: returns
    (`vm.fix_all` of the moved rows f[I, P, V], info). The tabu masks are
    built once for the batch.

    On a CUDA population one kernel (`ops/move_kernel.py`) moves and fixes
    the candidates from the same draw; elsewhere the torch body does
    (`do_move`, then `fix_all`), with the same rows."""
    with span("gj.moves.sample"):
        if not population.is_cuda:
            noise = draw_move_noise(generators, population.shape[1], vm, cfg,
                                    population.dtype)
            moved, info = do_move(population, noise, vm, cfg,
                                  cfg.tabu_masks(tabu_state))
            return vm.fix_all(moved), info
        fields = move_noise_fields(vm, cfg)
        u = draw_uniforms(generators, population.shape[1], fields, vm.device)
        masks = cfg.tabu_masks(tabu_state)
        with span("gj.moves.kernel"):
            return move_kernel.move_and_fix(u, field_columns(fields),
                                            population, vm, cfg, masks)


def dedupe_delta(delta):
    """Mask out later duplicates of the same position (their values are
    equal, so dropping them is exact). Works over any leading axes.

    Up to `config.MAX_NARROW_DELTA` entries by one [K, K] comparison;
    wider deltas by a stable sort of the valid positions, whose first of
    each run of equal positions is the earliest entry."""
    pos = delta["positions"]
    valid = delta["valid"]
    k = pos.shape[-1]
    if k > config.MAX_NARROW_DELTA:
        # invalid entries sort first under -1 (positions are ids >= 0)
        srt, order = torch.sort(torch.where(valid, pos, -1), dim=-1,
                                stable=True)
        first = torch.cat([torch.ones_like(valid[..., :1]),
                           srt[..., 1:] != srt[..., :-1]], dim=-1)
        keep = torch.empty_like(first).scatter_(-1, order, first)
        return {**delta, "valid": valid & keep}
    idx = torch.arange(k, device=pos.device)
    eq = ((pos[..., :, None] == pos[..., None, :])
          & valid[..., :, None] & valid[..., None, :])
    earlier_dup = torch.any(eq & (idx[None, :] < idx[:, None]), dim=-1)
    return {**delta, "valid": valid & ~earlier_dup}


def apply_delta(base, delta):
    """Materialize one delta per island: base f[I, V], delta leaves [I, K]
    (valid positions in [0, V)). Later delta entries win on position
    collisions. Narrow deltas (K <= 8) unroll to K selects; wider ones
    write each position's last valid entry, found by a max-scatter of the
    entry indices (order-free, so the same on every device), in O(K + V)."""
    kd = delta["positions"].shape[-1]
    if kd > 8:
        n_isl, v = base.shape
        kidx = torch.arange(kd, device=base.device).expand(n_isl, kd)
        # invalid entries go to a sentinel column that is cut off
        pos = torch.where(delta["valid"], delta["positions"].long(), v)
        last_k = torch.full((n_isl, v + 1), -1, dtype=torch.int64,
                            device=base.device).scatter_reduce_(
            1, pos, kidx, reduce="amax")[:, :v]
        val = torch.gather(delta["values"], 1, torch.clamp(last_k, min=0))
        return torch.where(last_k >= 0, val.to(base.dtype), base)
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
