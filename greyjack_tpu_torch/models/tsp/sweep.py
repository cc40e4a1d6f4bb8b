"""Sweep-neighbourhood scorer for TSP: dense value sweeps over tour stops
(counterpart of `greyjack_tpu/models/tsp/sweep.py`).

Per step and island, T sampled tour positions are scored against four
families, every delta exact closed-form leg arithmetic (no time windows):

  * change    — assign every location id 1..L-1 to the position: [T, L-1];
  * swap      — swap the position's value with every other's: [T, N], the
                general 6-leg splice plus the adjacent-pair correction;
  * reversal  — reverse positions [min(t, j), max(t, j)] (2-opt): [T, N];
  * insertion — move the position's city to sit after position j (or-opt):
                [T, N].

The lexicographic winner over the four families (ties to the lowest flat
index: change, swap, reversal, insertion, row-major inside each) becomes a
delta `cfg.kd` wide, by default the whole tour, so reversal and insertion
spans are uncapped; its exact (d_hard, d_dist) row comes straight from the
family tiles.

Every function carries a leading island axis I: ctx leaves [I, ...],
target rows [I, T], outputs [I, ...]. The JAX module fetches distance-
matrix rows and columns with one-hot matmuls and picks target values with
masked sums (a TPU has no fast gather); here they are integer gathers of
the i32 milli matrix, which give the same integers. Every result equals
the JAX package's bit for bit, dtype included.
"""

from __future__ import annotations

import numpy as np
import torch

from greyjack_tpu_torch.ops import lexico
from greyjack_tpu_torch.utils.math_utils import true_div
from greyjack_tpu_torch.utils.tracing import span

_I32 = torch.int32
_I64 = torch.int64
_STUB = int(np.iinfo(np.int32).max)
_DEFAULT_TARGETS = 64   # sampled tour positions per island-step


def eligible(utils):
    """Static eligibility, the JAX package's: distance magnitudes below
    2^24 (its one-hot matmuls are f32-exact there; kept so both packages
    engage the sweep on the same instances) and fewer than 2^16 locations
    (i32-safe flat indices and distance deltas)."""
    if utils.get("dm_max_milli", 1 << 30) >= (1 << 24):
        return False
    if utils["n_locations"] >= (1 << 16):
        return False
    return True


class SweepConfig:
    """Host-compiled statics on the requester's device: variable ids (one
    per tour position), the single semantic group's slot maps, the milli
    matrix with its transpose, and the winner-delta width `kd`."""

    def __init__(self, requester, targets=None, window=None):
        # explicit None check: `targets or default` would swallow 0
        self.targets = int(_DEFAULT_TARGETS if targets is None else targets)
        if self.targets <= 0:
            raise ValueError(f"sweep targets must be positive, got "
                             f"{self.targets}")
        schema = requester.planning_schema["path_stops"]
        var_ids = np.asarray(schema["var_ids_np"]["locations_vec_id"],
                             np.int32)
        # the target sampler draws from at most n_rows free slots
        self.targets = min(self.targets, len(var_ids))
        # a window > 0 caps the reversal / insertion span (and kd)
        self.window = 0 if window is None else int(window)
        vm = requester.variables_manager
        dev = vm.device

        def t(x):
            return torch.as_tensor(x, device=dev)

        self.var_ids = t(var_ids)
        self.n_rows = len(var_ids)
        self.float_dtype = vm.float_dtype
        self.g0 = 0  # the single semantic group ("common")
        members = vm.group_members_np
        var_row = np.zeros(vm.variables_count, np.int32)
        var_row[var_ids] = np.arange(self.n_rows, dtype=np.int32)
        self.row_of_slot = t(var_row[members[self.g0]])
        # slot of each row, -1 for a row with no slot (frozen stops are not
        # in semantic groups); the winner's tabu info pushes slots
        slot_of_row = np.full(self.n_rows, -1, np.int32)
        rs = var_row[members[self.g0]][: int(vm.group_sizes_np[self.g0])]
        slot_of_row[rs] = np.arange(len(rs), dtype=np.int32)
        self.slot_of_row = t(slot_of_row)
        self.group_lmax = vm.max_group_size
        self.slot_valid = t(np.arange(vm.max_group_size)
                            < int(vm.group_sizes_np[self.g0]))
        utils = requester._delta_utils()
        self.dm = utils["distance_matrix_milli"].to(_I32)
        # row gathers of dmT read dm's columns contiguously
        self.dmT = self.dm.T.contiguous()
        self.kd = (self.n_rows if self.window <= 0
                   else min(self.n_rows, self.window))

    def conservative_moves_per_step(self, utils, tabu_rate):
        """Static lower bound on candidates per island-step, for throughput
        accounting without a device read: the change family minus the
        no-op, the swap family minus worst-case tabu / self partners."""
        n = self.n_rows
        lc = utils["n_locations"] - 2       # values 1..L-1 minus the no-op
        tabu_cap = int(np.ceil(tabu_rate * n))
        return self.targets * (lc + max(0, n - 1 - tabu_cap))


def _cols(mat, idx):
    """out[i, t, j] = mat[i, t, idx[i, j]]: mat [I, T, L], idx int[I, N]."""
    i, t, _ = mat.shape
    return torch.gather(mat, 2, idx[:, None, :].expand(i, t, -1).long())


def score_candidates(ctx, t_rows, t_valid, row_tabu, cfg: SweepConfig,
                     utils):
    """Exact delta arrays of the four families for target rows i32[I, T]
    (t_valid bool[I, T], row_tabu bool[I, N]): hard = duplicate-count
    delta, dist = tour-milli delta, with validity masks, plus the target
    values the winner decode needs."""
    ni, t = t_rows.shape
    l = utils["n_locations"]
    lc = l - 1                              # legal values 1..L-1
    n = cfg.n_rows
    dm, dmt = cfg.dm, cfg.dmT
    dmf = utils["dm_flat_milli"]
    s = ctx["s"]
    counts = ctx["counts"]
    legs = ctx["legs"]                      # [I, N+1]
    dev = s.device

    with span("gj.sweep.tables"):
        # per-stop neighbours (the depot, 0, at both ends)
        zero = torch.zeros((ni, 1), dtype=s.dtype, device=dev)
        p_vec = torch.cat([zero, s[:, :-1]], dim=1)             # [I, N]
        n_vec = torch.cat([s[:, 1:], zero], dim=1)
        iota_n = torch.arange(n, dtype=_I32, device=dev)
        rows = t_rows.long()

        def pick(x):                        # [I, N] -> [I, T] at t_rows
            return torch.gather(x, 1, rows)

        t_c = pick(s)
        t_p = pick(p_vec)
        t_n = pick(n_vec)
        t_inleg = pick(legs[:, :-1])        # legs[t]
        t_outleg = pick(legs[:, 1:])        # legs[t+1]

        row_p = dm[t_p.long()]              # dm[prev, :]    [I, T, L]
        row_n = dmt[t_n.long()]             # dm[:, next]
        row_s = dm[t_c.long()]              # dm[c_t, :]
        row_sT = dmt[t_c.long()]            # dm[:, c_t]
        t_io = (t_inleg + t_outleg)[..., None]

    # --- change [T, Lc]: values c = 1..L-1 ----------------------------------
    with span("gj.sweep.change"):
        cand = torch.arange(1, l, dtype=_I32, device=dev)
        a_dist = row_p[..., 1:] + row_n[..., 1:] - t_io
        dups_gone = (torch.gather(counts, 1, t_c.long()) == 1).to(_I32)
        appears_new = (counts[:, None, 1:] == 0).to(_I32)
        same = cand == t_c[..., None]
        a_hard = torch.where(same, 0, dups_gone[..., None] - appears_new)
        a_valid = t_valid[..., None] & ~same    # the no-op is excluded

    # --- swap [T, N]: the general 6-leg splice; adjacent pairs replace the
    # shared leg by its reverse ------------------------------------------------
    with span("gj.sweep.swap"):
        rps = _cols(row_p, s)               # dm[p_t, c_j]
        rns = _cols(row_n, s)               # dm[c_j, n_t]
        rstp = _cols(row_sT, p_vec)         # dm[p_j, c_t]
        rsn = _cols(row_s, n_vec)           # dm[c_t, n_j]
        legs_j = legs[:, None, :-1]
        legs_j1 = legs[:, None, 1:]
        g = rps + rns + rstp + rsn - t_io - (legs_j + legs_j1)
        rev_in = dmf[(t_c * l + t_p).long()]    # dm[c_t, prev_t]
        rev_out = dmf[(t_n * l + t_c).long()]   # dm[next_t, c_t]
        tr = t_rows[..., None]
        is_next = tr + 1 == iota_n
        is_prev = tr - 1 == iota_n
        c_dist = (g
                  + torch.where(is_next, (rev_out + t_outleg)[..., None], 0)
                  + torch.where(is_prev, (rev_in + t_inleg)[..., None], 0))
        zeros_tn = torch.zeros((ni, t, n), dtype=_I32, device=dev)
        not_self = iota_n != tr
        untabu = ~row_tabu[:, None, :]
        c_valid = (t_valid[..., None] & not_self
                   & (s[:, None, :] != t_c[..., None])  # equal values: no-op
                   & untabu)

    # --- 2-opt reversal [T, N] of positions [min(t, j), max(t, j)]: the
    # interior legs keep their lengths only for symmetric matrices, which
    # this model always builds; span capped at kd - 1 ----------------------
    with span("gj.sweep.two_opt"):
        jgt = iota_n > tr
        r_dist = torch.where(jgt, rps + rsn - t_inleg[..., None] - legs_j1,
                             rstp + rns - legs_j - t_outleg[..., None])
        span_ok = torch.abs(iota_n - tr) <= cfg.kd - 1
        r_valid = t_valid[..., None] & not_self & span_ok & untabu

    # --- or-opt insertion [T, N]: the target's city moves to sit right
    # after position j (remove splice + insert splice) ----------------------
    with span("gj.sweep.or_opt"):
        splice_t = dmf[(t_p * l + t_n).long()]  # dm[p_t, n_t]
        rss = _cols(row_sT, s)                  # dm[c_j, c_t]
        i_dist = ((splice_t - t_inleg - t_outleg)[..., None] + rss + rsn
                  - legs_j1)
        i_valid = (t_valid[..., None] & not_self & (iota_n != tr - 1)
                   & span_ok & untabu)

    return {
        "a_hard": a_hard, "a_dist": a_dist, "a_valid": a_valid,
        "a_conv": torch.ones((ni, t, lc), dtype=torch.bool, device=dev),
        "c_hard": zeros_tn, "c_dist": c_dist, "c_valid": c_valid,
        "c_conv": torch.ones((ni, t, n), dtype=torch.bool, device=dev),
        "r_hard": zeros_tn.clone(), "r_dist": r_dist, "r_valid": r_valid,
        "i_hard": zeros_tn.clone(), "i_dist": i_dist, "i_valid": i_valid,
        "t_rows": t_rows, "t_c": t_c, "s": s,
    }


# --------------------------------------------------------------------------
# the sweep proposal
# --------------------------------------------------------------------------

def sample_targets(generators, ctx, free, cfg: SweepConfig):
    """T distinct tabu-free tour rows per island, drawn from the island's
    generator: one f32 uniform per group slot, +2.0 past the free count,
    the first T of a stable argsort. Returns (t_rows i32[I, T], t_valid
    bool[I, T])."""
    free_list, free_count = free
    fc = free_count[:, cfg.g0]                                # [I]
    lmax = cfg.group_lmax
    dev = free_list.device
    slot = torch.arange(lmax, device=dev)
    u = torch.stack([torch.rand(lmax, generator=g, dtype=torch.float32,
                                device=dev) for g in generators])
    keys = u + torch.where(slot < fc[:, None], 0.0, 2.0)
    order = torch.argsort(keys, dim=-1, stable=True)[:, :cfg.targets]
    t_valid = torch.arange(cfg.targets, device=dev) < fc[:, None]
    t_slots = torch.gather(free_list[:, cfg.g0], 1, order)
    return cfg.row_of_slot[t_slots.long()], t_valid


def tabu_rows(tabu_masks, cfg: SweepConfig, n_islands):
    """bool[I, N]: tour rows whose slot is tabu. An OR over slots: the
    member table's pad slots alias row 0 with False and must not erase a
    real True, so slot hits are counted, not written."""
    n = cfg.n_rows
    dev = cfg.row_of_slot.device
    if tabu_masks is None:
        return torch.zeros((n_islands, n), dtype=torch.bool, device=dev)
    hits = (tabu_masks[:, cfg.g0] & cfg.slot_valid).to(_I32)
    return torch.zeros((n_islands, n), dtype=_I32, device=dev).index_add_(
        1, cfg.row_of_slot.long(), hits) > 0


def propose_from_targets(ctx, t_rows, t_valid, row_tabu, cfg: SweepConfig,
                         utils):
    """The deterministic half of `propose`: score the four families of the
    given targets, take the lexicographic winner and decode it. Returns
    (winner_delta width cfg.kd, exact i32[I, 2] (d_hard, d_dist_milli),
    tabu_info, stats); `exact` is INT32_MAX-stubbed when no candidate is
    valid (the accept rule then rejects)."""
    n = cfg.n_rows
    l = utils["n_locations"]
    lc = l - 1
    ni, t = t_rows.shape
    dev = t_rows.device
    sc = score_candidates(ctx, t_rows, t_valid, row_tabu, cfg, utils)

    with span("gj.sweep.select"):
        def keyrow(hard, dist, val):
            k2 = torch.stack([hard, dist], dim=-1)
            return torch.where(val[..., None], k2, _STUB).reshape(ni, -1, 2)

        keys_all = torch.cat([
            keyrow(sc["a_hard"], sc["a_dist"], sc["a_valid"]),
            keyrow(sc["c_hard"], sc["c_dist"], sc["c_valid"]),
            keyrow(sc["r_hard"], sc["r_dist"], sc["r_valid"]),
            keyrow(sc["i_hard"], sc["i_dist"], sc["i_valid"]),
        ], dim=1)                                    # [I, T*Lc + 3*T*N, 2]
        best = lexico.lex_argmin(keys_all)                    # [I]
        n_a = t * lc
        fam = ((best >= n_a).to(_I64) + (best >= n_a + t * n).to(_I64)
               + (best >= n_a + 2 * t * n).to(_I64))          # 0..3
        off = best - torch.where(fam == 0, 0, n_a + (fam - 1) * (t * n))
        per = torch.where(fam == 0, lc, n)
        ti = off // per
        vi = off % per                    # < n: the change family has L-1

        def pick(x, i):                                       # [I, X] at [I]
            return torch.gather(x, 1, i[:, None].long())[:, 0]

        s_tour = sc["s"]
        w_row = pick(sc["t_rows"], ti).to(_I64)
        w_c_old = pick(sc["t_c"], ti)
        j_c = pick(s_tour, vi)

        # --- winner delta, width cfg.kd --------------------------------------
        kidx = torch.arange(cfg.kd, dtype=_I64, device=dev)[None, :]
        a = torch.minimum(w_row, vi)[:, None]
        b = torch.maximum(w_row, vi)[:, None]
        width = b - a + 1
        fam_, vi_ = fam[:, None], vi[:, None]
        w_row_ = w_row[:, None]

        def s_at(idx):                                        # [I, kd]
            return torch.gather(s_tour, 1, torch.clamp(idx, 0, n - 1))

        var_ids = cfg.var_ids
        # change: one var at w_row gets 1+vi; swap: w_row and vi exchange;
        # reversal: positions a..b get s[b - k]; insertion after j: j > t
        # rotates [t..j] left (the last slot gets s[a]), j < t rotates
        # [j+1..t] right (the first slot gets s[t])
        jgt = vi_ > w_row_
        start = torch.where((fam_ == 3) & ~jgt, a + 1, a)
        pos_var = var_ids[torch.clamp(start + kidx, 0, n - 1)]
        v_change = torch.where(kidx == 0, 1 + vi_, 0)
        pos_w = var_ids[w_row_]
        pos_change = torch.where(kidx == 0, pos_w, pos_var)
        v_swap = torch.where(kidx == 0, j_c[:, None], w_c_old[:, None])
        pos_swap = torch.where(kidx == 0, pos_w,
                               var_ids[torch.clamp(vi_, max=n - 1)])
        v_rev = s_at(b - kidx)
        v_ins = torch.where(
            jgt,
            torch.where(kidx == width - 1, s_at(a), s_at(a + 1 + kidx)),
            torch.where(kidx == 0, s_at(b), s_at(start + kidx - 1)))
        positions = torch.where((fam_ <= 1) & (kidx < 2),
                                torch.where(fam_ == 0, pos_change, pos_swap),
                                pos_var).to(_I32)
        values = torch.where(fam_ == 0, v_change,
                             torch.where(fam_ == 1, v_swap,
                                         torch.where(fam_ == 2, v_rev, v_ins)))
        isl = torch.arange(ni, device=dev)
        best_key = keys_all[isl, best]                        # [I, 2]
        any_valid = best_key[:, 0] != _STUB
        nvalid = torch.where(fam_ == 0, 1,
                             torch.where(fam_ == 1, 2,
                                         torch.where((fam_ == 2) | jgt,
                                                     width, width - 1)))
        delta = {
            "positions": positions,
            "values": values.to(cfg.float_dtype),
            "valid": (kidx < nvalid) & any_valid[:, None],
        }
    with span("gj.sweep.exact"):
        # the winner's exact (d_hard, d_dist) straight from the family
        # tiles: every TSP family delta is exact closed-form leg arithmetic
        exact = torch.where(any_valid[:, None], best_key, _STUB).to(_I32)

    with span("gj.sweep.select"):
        # the tabu rings hold group slots, not tour rows: map through
        # slot_of_row and drop a slotless (frozen) partner from the push
        w_slot = cfg.slot_of_row[w_row]
        partner_slot = cfg.slot_of_row[torch.clamp(vi, max=n - 1)]
        has_partner = (fam >= 1) & (partner_slot >= 0)
        info = {
            "group": torch.full((ni,), cfg.g0, dtype=_I32, device=dev),
            "positions": torch.stack(
                [w_slot, torch.where(has_partner, partner_slot, w_slot)],
                dim=-1).to(_I32),
            "count": torch.where(has_partner, 2, 1).to(_I32),
        }

        def total(m):
            return torch.sum(m, dim=(1, 2), dtype=_I64)

        stats = {"n_scored": (total(sc["a_valid"]) + total(sc["c_valid"])
                              + total(sc["r_valid"]) + total(sc["i_valid"])),
                 "n_nonconv": torch.zeros((ni,), dtype=_I64, device=dev)}
    return delta, exact, info, stats


def propose(generators, ctx, free, tabu_masks, cfg: SweepConfig, utils):
    """Sample T targets per island from its generator (tabu-free slots),
    then `propose_from_targets`. `free` is `MoverConfig.tabu_free`'s pair,
    `tabu_masks` its `tabu_masks` (None without tabu)."""
    with span("gj.sweep.propose"):
        with span("gj.sweep.targets"):
            t_rows, t_valid = sample_targets(generators, ctx, free, cfg)
            row_tabu = tabu_rows(tabu_masks, cfg, t_rows.shape[0])
        return propose_from_targets(ctx, t_rows, t_valid, row_tabu, cfg,
                                    utils)


def exact_score_row(ctx, exact_ints, utils):
    """f64[I, 2] score row of each island's winner from the ctx's exact sums
    and the winner's exact integer deltas (LateAcceptance's ring compares
    against it); the stub row where the winner is stubbed."""
    hard = (ctx["hard"] + exact_ints[..., 0]).to(torch.float64)
    soft = true_div((ctx["soft_milli"] + exact_ints[..., 1]).to(
        torch.float64), 1000.0)
    row = torch.stack([hard, soft], dim=-1)
    return torch.where((exact_ints[..., 0] == _STUB)[..., None],
                       lexico.stub_score_row(2, device=row.device), row)
