"""Sweep-neighbourhood scorer for VRP: dense value sweeps over sampled stops
(counterpart of `greyjack_tpu/models/vrp/sweep.py`).

Per step and island, T sampled target stops are scored against

  * change-sweep  — every legal customer id:          a [T, Lc] tile;
  * vehicle-sweep — every vehicle:                     a [T, K] tile;
  * swap-sweep    — every other stop's customer:       a [T, N] tile;

from per-route cumulant tables that are rebuilt from the delta ctx once per
step (`build_tables`). Hard (duplicates + overflow) and distance deltas are
exact for every candidate. Lateness deltas are exact where the `conv` flag
says the perturbation re-converges with the stored schedule inside the
W-position window (the vehicle-sweep evaluates full suffixes and is always
exact); elsewhere they are an optimistic lower bound. The lexicographic
winner is re-scored exactly before the accept decision, so an accepted
move's score is always exact. The winner is a narrow (kd=2) delta, so
apply / `update_ctx` / tabu machinery is the random-move path's.

Every function carries a leading island axis I: ctx leaves [I, ...],
target rows [I, T], outputs [I, ...]. The JAX module's one-hot matmul row
fetches and masked-sum selects are integer gathers here, and its Python
loops over the window W are one broadcast over a trailing [..., W] axis;
integer sums do not depend on the order. Every integer result equals the
JAX package's bit for bit, dtype included: where `jnp.sum` promotes i32 to
i64 (x64 mode), the port casts to i64 as well.
"""

from __future__ import annotations

import numpy as np
import torch

from greyjack_tpu_torch.models.vrp import cotwin_builder as cb
from greyjack_tpu_torch.ops import lexico

_I32 = torch.int32
_I64 = torch.int64
_BIG = 1 << 28          # -inf stand-in for i32 time math (times < 2^22)
_STUB = int(np.iinfo(np.int32).max)
_DEFAULT_TARGETS = 64   # sampled target stops per island-step
_DEFAULT_WINDOW = 16    # suffix positions re-walked per candidate


def _relu(x):
    return torch.clamp(x, min=0)


def eligible(utils):
    """Static eligibility: i32 accumulation, distance magnitudes below 2^24
    (the reference's one-hot matmul bound, kept so both packages engage the
    sweep on the same instances), and time bounds small enough that the
    (nrem+1)*shift lateness lower bound cannot overflow i32 (see
    `_suffix_window`)."""
    if utils["acc_dtype"] != torch.int32:
        return False
    if utils.get("dm_max_milli", 1 << 30) >= (1 << 24):
        return False
    if utils.get("t_max", 0) >= (1 << 22):
        return False
    if utils["n_locations"] >= (1 << 16):
        return False
    return True


class SweepConfig:
    """Host-compiled static tables + knobs for the sweep step: per-row
    variable ids, frozen masks, tabu-group slot maps and the milli distance
    matrix with its transpose, on the requester's device."""

    def __init__(self, requester, targets=None, window=None):
        # explicit None checks: `targets or default` would silently replace
        # an explicit 0 with the default instead of rejecting it
        self.targets = int(_DEFAULT_TARGETS if targets is None else targets)
        self.window = int(_DEFAULT_WINDOW if window is None else window)
        if self.targets <= 0 or self.window <= 0:
            raise ValueError(
                f"sweep targets/window must be positive, got "
                f"targets={self.targets} window={self.window}")
        schema = requester.planning_schema["planning_stops"]
        # the target sampler draws from at most n_rows free slots
        self.targets = min(self.targets,
                           len(schema["var_ids_np"]["customer_id"]))
        vm = requester.variables_manager
        dev = vm.device

        def t(x):
            return torch.as_tensor(x, device=dev)

        cust_vars = np.asarray(schema["var_ids_np"]["customer_id"], np.int32)
        veh_vars = np.asarray(schema["var_ids_np"]["vehicle_id"], np.int32)
        self.n_rows = len(cust_vars)
        frozen = vm.frozen_mask_np
        self.frozen_cust_np = frozen[cust_vars]
        self.frozen_veh_np = frozen[veh_vars]
        self.cust_var = t(cust_vars)
        self.veh_var = t(veh_vars)
        self.frozen_cust = t(self.frozen_cust_np)
        self.frozen_veh = t(self.frozen_veh_np)
        self.float_dtype = vm.float_dtype

        keys = vm.semantic_group_keys
        self.g_cust = keys.index("customer_assignment")
        self.g_veh = keys.index("vehicle_assignment")
        # group slot <-> stop row maps (group members exclude frozen vars)
        members = vm.group_members_np
        var_row = np.zeros(vm.variables_count, np.int32)
        var_row[cust_vars] = np.arange(self.n_rows, dtype=np.int32)
        var_row[veh_vars] = np.arange(self.n_rows, dtype=np.int32)
        self.row_of_cust_slot = t(var_row[members[self.g_cust]])
        slot_of_row_c = np.full(self.n_rows, -1, np.int32)
        cs = var_row[members[self.g_cust]][: vm.group_sizes_np[self.g_cust]]
        slot_of_row_c[cs] = np.arange(len(cs), dtype=np.int32)
        slot_of_row_v = np.full(self.n_rows, -1, np.int32)
        vs = var_row[members[self.g_veh]][: vm.group_sizes_np[self.g_veh]]
        slot_of_row_v[vs] = np.arange(len(vs), dtype=np.int32)
        self.slot_of_row_cust = t(slot_of_row_c)
        self.slot_of_row_veh = t(slot_of_row_v)
        self.cust_group_lmax = vm.max_group_size
        self.cust_slot_valid = t(np.arange(vm.max_group_size)
                                 < int(vm.group_sizes_np[self.g_cust]))

        utils = requester._delta_utils()
        self.dm = utils["distance_matrix_milli"].to(_I32)
        # row gathers of dmT read dm's columns contiguously
        self.dmT = self.dm.T.contiguous()

    def conservative_moves_per_step(self, utils, tabu_rate):
        """Static LOWER bound on candidates scored per island-step, for
        throughput accounting without a device read: the change-sweep
        exactly, the swap-sweep minus worst-case masked partners (frozen +
        tabu capacity + one full route), the vehicle-sweep as zero."""
        n = self.n_rows
        lc = utils["n_stops"] - 1          # the no-op candidate is excluded
        frozen = int(self.frozen_cust_np.sum())
        tabu_cap = int(np.ceil(tabu_rate * max(1, n - frozen)))
        swap_lb = max(0, n - frozen - tabu_cap - utils["route_cap"] - 1)
        return self.targets * (lc + swap_lb)


# --------------------------------------------------------------------------
# per-step tables (from ctx, O(K*R) work)
# --------------------------------------------------------------------------

_NC_BASE = 20  # window columns start here in the stop table
# the stop table's scalar columns, in order
_COLS = ("v", "c", "pos", "dem", "ct", "fl", "ce", "postprev", "p", "late",
         "u0", "inleg", "outleg", "prev", "next", "len", "w1", "ot", "load",
         "cap")


def _shift_windows(x, w, fill):
    """[..., R] -> [..., R, W] with out[..., s, j] = x[..., s+1+j], `fill`
    past the end: column j is the JAX module's `_shift_left(x, j+1, fill)`,
    all W shifts as one strided view of one padded copy."""
    pad = torch.full(x.shape[:-1] + (w,), fill, dtype=x.dtype,
                     device=x.device)
    return torch.cat([x[..., 1:], pad], dim=-1).unfold(-1, w, 1)


def _route_view(ctx):
    """The ctx route grids [I, K, R] and per-vehicle scalars of every
    route (the JAX module's `veh_sel=None` branch)."""
    grids = ("r_stop", "r_ct", "r_floor", "r_ce", "r_c", "r_leg")
    view = {g: ctx[g] for g in grids}
    view["vp"] = ctx["veh_pack"]
    view["len"] = ctx["len"].to(_I32)
    return view


def _tables_core(view, cfg: SweepConfig, utils, n):
    """Cumulant arrays for the viewed routes: the packed per-stop grid rows
    [I, K*R, C] (C = 20 + 4W) plus the [I, K, R] / [I, K] route arrays the
    vehicle-sweep needs."""
    w = cfg.window
    ni, kk, r = view["r_stop"].shape
    tw = bool(utils["time_windowed"])
    dev = view["r_stop"].device

    valid = view["r_stop"] < n
    len_k = view["len"]                                       # [I, K]
    iota_r = torch.arange(r, dtype=_I32, device=dev)
    vp = view["vp"]
    w0 = vp[..., 0:1]                                         # [I, K, 1]
    w1 = vp[..., 1]
    ct = torch.where(valid, view["r_ct"], 0)
    fl = torch.where(valid, view["r_floor"], -_BIG)
    ce = view["r_ce"]
    p_arr = torch.cumsum(ct, dim=-1, dtype=_I32)
    d_arr = fl - p_arr
    if tw:
        post = p_arr + torch.maximum(w0, torch.cummax(d_arr, dim=-1).values)
        late = torch.where(valid, _relu(post - ce), 0)
        ot = torch.where(len_k > 0, _relu(post[..., -1] - w1), 0)
    else:
        post = p_arr
        late = torch.zeros_like(p_arr)
        ot = torch.zeros((ni, kk), dtype=_I32, device=dev)
    e_arr = p_arr - ce

    # anchor grids [I, K, R]: value at a = state *entering* slot a
    zcol = torch.zeros((ni, kk, 1), dtype=_I32, device=dev)
    pprev = torch.cat([zcol, p_arr[..., :-1]], dim=-1)
    postprev = torch.cat([w0, post[..., :-1]], dim=-1)

    depots = vp[..., 7]
    c_g = view["r_c"]
    first_c = c_g[..., 0]
    last_c = torch.gather(c_g, -1,
                          _relu(len_k - 1)[..., None].long())[..., 0]
    dmf = utils["dm_flat_milli"]
    l = utils["n_locations"]
    has = len_k > 0
    startleg = torch.where(has, dmf[depots.long() * l + first_c], 0)
    endleg = torch.where(has, dmf[last_c.long() * l + depots], 0)

    # per-stop in/out legs incl depot boundary legs
    first = iota_r == 0
    last = iota_r == (len_k[..., None] - 1)
    r_leg = view["r_leg"]
    inleg = torch.where(first, startleg[..., None],
                        torch.cat([zcol, r_leg[..., :-1]], dim=-1))
    outleg = torch.where(last, endleg[..., None], r_leg)
    prev_c = torch.where(first, depots[..., None],
                         torch.cat([zcol, c_g[..., :-1]], dim=-1))
    next_c = torch.where(last, depots[..., None],
                         torch.cat([c_g[..., 1:], zcol], dim=-1))

    # window tables anchored at a = slot+1: wsh[., s, j] = max D[s+1..s+1+j],
    # floored at -BIG (empty slots carry D = -BIG - P below it)
    wsh = torch.clamp(torch.cummax(_shift_windows(d_arr, w, -_BIG),
                                   dim=-1).values, min=-_BIG)
    esh = _shift_windows(e_arr, w, 0)
    lsh = _shift_windows(late, w, 0)
    psh = _shift_windows(p_arr, w, 0)

    def bc(x):                                                # [I, K] -> grid
        return x[..., None].expand(ni, kk, r)

    cols = [
        torch.arange(kk, dtype=_I32, device=dev)[:, None].expand(ni, kk, r),
        c_g,
        iota_r.expand(ni, kk, r),
        torch.zeros_like(c_g),                  # dem (filled by the caller)
        ct, fl, ce,
        postprev, p_arr, late,
        post - p_arr,                           # u0 of suffix anchor slot+1
        inleg, outleg, prev_c, next_c,
        bc(len_k), bc(w1), bc(ot),
        bc(vp[..., 5]),                         # load
        bc(vp[..., 6]),                         # cap
    ]
    grid = torch.cat([torch.stack(cols, dim=-1), wsh, esh, lsh, psh],
                     dim=-1).reshape(ni, kk * r, _NC_BASE + 4 * w)

    # vehicle-sweep insertion grids [I, K, R]: value at insertion rank a
    in_route = iota_r < len_k[..., None]
    gapleg = torch.where(
        first, startleg[..., None],
        torch.where(in_route, inleg,
                    torch.where(iota_r == len_k[..., None],
                                endleg[..., None], 0)))
    # at a == len the slot holds no stop: next after insertion is the depot
    ncand = torch.where(in_route, c_g, depots[..., None])

    route = {"d": d_arr, "e": e_arr, "late": late, "p": p_arr,
             "valid": valid, "len": len_k, "w1": w1, "ot": ot,
             "pprev": pprev, "postprev": postprev,
             "gapleg": gapleg, "pcand": prev_c, "ncand": ncand,
             "depots": depots}
    return grid, route


def build_tables(ctx, cfg: SweepConfig, utils):
    """Per-position route cumulants, packed as one stop-indexed table
    S[I, N, 20+4W] (one scatter by r_stop; sentinel stops land in a spare
    row that is cut off, as the reference's `mode="drop"` drops them) plus
    [I, K, R] insertion-anchor grids for the vehicle-sweep."""
    ni, n = ctx["v"].shape
    grid, route = _tables_core(_route_view(ctx), cfg, utils, n)
    # each stop sits in one route slot at most, so only the spare row is
    # written twice
    idx = ctx["r_stop"].reshape(ni, -1, 1).long().expand_as(grid)
    stop_tbl = torch.zeros((ni, n + 1, grid.shape[-1]), dtype=_I32,
                           device=grid.device).scatter_(1, idx, grid)[:, :n]
    # dem column from cust_packed (constant per customer, not per slot)
    stop_tbl[..., 3] = utils["cust_packed"][ctx["c"].long(), 0]
    return stop_tbl, route


def _suffix_window(trow, u, tw, w):
    """Windowed suffix lateness delta for a payload change at the anchor's
    slot: d = sum_j hinge(max(u, W_j) + e_j) - late_j over the W downstream
    positions, plus the in-window overtime delta. Returns (lower bound,
    conv) — exact when `conv` (window covers the suffix or the schedule
    provably re-converges at the window edge).

    trow: anchor data broadcastable against u — dict with a (slot+1), len,
    u0, w1, ot and window rows w2/e2/l2/p2 each [..., W].
    """
    a = trow["a"]
    ln = trow["len"]
    if not tw:
        z = torch.zeros(torch.broadcast_shapes(u.shape, a.shape),
                        dtype=_I32, device=u.device)
        return z, z == 0
    aj = a[..., None] + torch.arange(w, dtype=_I32, device=u.device)
    vw = aj < ln[..., None]
    m = torch.maximum(u[..., None], trow["w2"])               # [..., W]
    term = torch.where(vw, _relu(m + trow["e2"]) - trow["l2"], 0)
    endw = vw & (aj == ln[..., None] - 1)
    term = term + torch.where(
        endw, _relu(m + trow["p2"] - trow["w1"][..., None])
        - trow["ot"][..., None], 0)
    d = torch.sum(term, dim=-1, dtype=_I32)
    covered = (ln - a) <= w
    wl = trow["w2"][..., w - 1]
    conv = covered | (torch.maximum(u, wl) == torch.maximum(trow["u0"], wl))
    # optimistic remainder: each beyond-window term (and the overtime) can
    # drop by at most the backward shift u0-u; i32-safe by the t_max < 2^22
    # eligibility gate (nrem+1 <= R+1, shift < 2^22)
    nrem = _relu(ln - a - w)
    d = d - torch.where(conv, 0, (nrem + 1) * _relu(trow["u0"] - u))
    return d, conv


def _target_window(rows):
    """Anchor-data dict from gathered stop-table rows [..., C]."""
    w = (rows.shape[-1] - _NC_BASE) // 4
    return {
        "a": rows[..., 2] + 1,
        "len": rows[..., 15],
        "u0": rows[..., 10],
        "w1": rows[..., 16],
        "ot": rows[..., 17],
        "w2": rows[..., _NC_BASE:_NC_BASE + w],
        "e2": rows[..., _NC_BASE + w:_NC_BASE + 2 * w],
        "l2": rows[..., _NC_BASE + 2 * w:_NC_BASE + 3 * w],
        "p2": rows[..., _NC_BASE + 3 * w:_NC_BASE + 4 * w],
    }


def _columns(rows):
    """Named scalar columns of stop-table rows [..., C]."""
    return {name: rows[..., i] for i, name in enumerate(_COLS)}


def _insert_axis(win, axis):
    """Anchor-data dict with a size-1 axis inserted at `axis`, so it
    broadcasts against a candidate axis there."""
    return {k: v.unsqueeze(axis) for k, v in win.items()}


# --------------------------------------------------------------------------
# candidate scoring (separated from target sampling for parity tests)
# --------------------------------------------------------------------------

def _change_sweep(tg, twin, row_prev, row_next, counts, t_valid, cfg, utils):
    """Family A: replace each target's customer by every customer id,
    [I, T, Lc]."""
    l = utils["n_locations"]
    nd = l - utils["n_stops"]
    tw = bool(utils["time_windowed"])
    dev = row_prev.device
    cust = utils["cust_packed"][nd:]                          # [Lc, 4]
    c_dem, c_ct, c_ce = cust[:, 0], cust[:, 3], cust[:, 2]
    c_fl = cust[:, 1] + cust[:, 3]

    def col(name):
        return tg[name][..., None]

    a_dist = (row_prev[..., nd:] + row_next[..., nd:]
              - (tg["inleg"] + tg["outleg"])[..., None])
    a_over = (_relu(col("load") - col("dem") + c_dem - col("cap"))
              - _relu(tg["load"] - tg["cap"])[..., None])
    same = torch.arange(nd, l, dtype=_I32, device=dev) == col("c")
    # d_dups = uniq - uniq': removing the old customer loses a unique iff
    # its count was 1; adding the candidate gains one iff its count was 0
    dups_gone = (torch.gather(counts, 1, tg["c"].long()) == 1).to(_I32)
    appears_new = (counts[:, None, nd:] == 0).to(_I32)
    a_dups = torch.where(same, 0, dups_gone[..., None] - appears_new)
    if tw:
        post_new = torch.maximum(col("postprev") + c_ct, c_fl)
        u_a = post_new - col("p")
        d_at = _relu(post_new - c_ce) - col("late")
        sfx, conv_a = _suffix_window(twin, u_a, tw, cfg.window)
        d_end = torch.where((tg["pos"] == tg["len"] - 1)[..., None],
                            _relu(post_new - col("w1")) - col("ot"), 0)
        a_late = d_at + sfx + d_end
    else:
        a_late = torch.zeros(a_dist.shape, dtype=_I32, device=dev)
        conv_a = torch.ones(a_dist.shape, dtype=torch.bool, device=dev)
    # the no-op candidate (c == current customer) is excluded: it ties
    # every real sideways move at 0 and would win by index order
    return {"a_hard": 1000 * a_dups + a_over, "a_late": a_late,
            "a_dist": a_dist, "a_valid": t_valid[..., None] & ~same,
            "a_conv": conv_a}


def _vehicle_sweep(ctx, tg, t_rows, t_valid, route, row_self, row_selfT,
                   splice, cfg, utils):
    """Family B: move each target stop to every vehicle, [I, T, K]; exact
    full-suffix evaluation on both routes."""
    ni, t = t_rows.shape
    kk = utils["k_vehicles"]
    r = utils["route_cap"]
    tw = bool(utils["time_windowed"])
    dev = t_rows.device
    is_last = tg["pos"] == tg["len"] - 1

    # removal side (exact, [I, T, R] suffix grid on the target's route)
    iota_r = torch.arange(r, dtype=_I32, device=dev)
    if tw:
        rt_d = cb._take(route["d"], tg["v"])
        rt_e = cb._take(route["e"], tg["v"])
        rt_late = cb._take(route["late"], tg["v"])
        rt_p = cb._take(route["p"], tg["v"])
        u_rem = tg["postprev"] - tg["p"]
        m_sfx = iota_r > tg["pos"][..., None]
        w_rem = torch.cummax(torch.where(m_sfx, rt_d, -_BIG), dim=-1).values
        vv = m_sfx & (iota_r < tg["len"][..., None])
        mterm = torch.maximum(u_rem[..., None], w_rem)
        d_sfx = torch.sum(torch.where(vv, _relu(mterm + rt_e) - rt_late, 0),
                          dim=-1, dtype=_I64)
        endm = vv & (iota_r == tg["len"][..., None] - 1)
        d_ot = torch.sum(torch.where(
            endm, _relu(mterm + rt_p - tg["w1"][..., None])
            - tg["ot"][..., None], 0), dim=-1, dtype=_I64)
        rem_late = (-tg["late"] + d_sfx + d_ot
                    + torch.where(is_last, _relu(tg["postprev"] - tg["w1"])
                                  - tg["ot"], 0))             # [I, T]
    else:
        rem_late = torch.zeros((ni, t), dtype=_I32, device=dev)
    rem_dist = splice - tg["inleg"] - tg["outleg"]
    rem_over = (_relu(tg["load"] - tg["dem"] - tg["cap"])
                - _relu(tg["load"] - tg["cap"]))

    # insertion side: rank by stop-id order (matches the sorted merge of
    # `_delta_parts_sorted`), exact full-suffix evaluation on [I, T, K, R]
    rstop = ctx["r_stop"]
    rho = torch.sum(rstop[:, None] < t_rows[..., None, None], dim=-1,
                    dtype=_I32)                               # [I, T, K]
    # rank R (a full route) selects nothing, as the reference's masked sum
    in_grid = rho < r
    isl = torch.arange(ni, device=dev)[:, None, None]
    veh = torch.arange(kk, device=dev)[None, None, :]
    rho_c = torch.clamp(rho, max=r - 1).long()

    def at_rho(g):                                  # [I, K, R] -> [I, T, K]
        return torch.where(in_grid, g[isl, veh, rho_c], 0).to(_I64)

    i_pprev = at_rho(route["pprev"])
    i_postprev = at_rho(route["postprev"])
    i_gapleg = at_rho(route["gapleg"])
    i_pc = at_rho(route["pcand"])
    i_nc = at_rho(route["ncand"])
    r_len = route["len"][:, None, :]                          # [I, 1, K]
    # the append rank (rho == len) reads the grids' a == len cells, which
    # carry the correct entering-end values; len == R routes are invalid
    if tw:
        post_new_b = torch.maximum(i_postprev + tg["ct"][..., None],
                                   tg["fl"][..., None])
        u_ins = post_new_b - i_pprev
        m_ins = iota_r >= rho[..., None]                      # [I, T, K, R]
        w_ins = torch.cummax(torch.where(m_ins, route["d"][:, None], -_BIG),
                             dim=-1).values
        vv_b = m_ins & (iota_r < r_len[..., None])
        mterm_b = torch.maximum(u_ins[..., None], w_ins)
        d_sfx_b = torch.sum(torch.where(
            vv_b, _relu(mterm_b + route["e"][:, None])
            - route["late"][:, None], 0), dim=-1)
        endm_b = vv_b & (iota_r == r_len[..., None] - 1)
        d_ot_b = torch.sum(torch.where(
            endm_b, _relu(mterm_b + route["p"][:, None]
                          - route["w1"][:, None, :, None])
            - route["ot"][:, None, :, None], 0), dim=-1)
        append = rho == r_len
        ins_late = (_relu(post_new_b - tg["ce"][..., None]) + d_sfx_b
                    + d_ot_b
                    + torch.where(append,
                                  _relu(post_new_b - route["w1"][:, None, :])
                                  - route["ot"][:, None, :], 0))
    else:
        ins_late = torch.zeros((ni, t, kk), dtype=_I32, device=dev)
    # legs dm[pc, c_t] + dm[c_t, nc] from the target's own dm rows
    leg_in_b = torch.gather(row_selfT, -1, i_pc)
    leg_out_b = torch.gather(row_self, -1, i_nc)
    ins_dist = leg_in_b.to(_I64) + leg_out_b - i_gapleg
    loads = ctx["veh_pack"][:, None, :, 5]
    caps = ctx["veh_pack"][:, None, :, 6]
    ins_over = (_relu(loads + tg["dem"][..., None] - caps)
                - _relu(loads - caps))

    b_valid = (t_valid[..., None]
               & (torch.arange(kk, dtype=_I32, device=dev)
                  != tg["v"][..., None])
               & (r_len < r)
               & ~cfg.frozen_veh[t_rows.long()][..., None])
    return {"b_hard": rem_over[..., None] + ins_over,
            "b_late": rem_late[..., None] + ins_late,
            "b_dist": rem_dist[..., None] + ins_dist,
            "b_valid": b_valid,
            "b_conv": torch.ones(b_valid.shape, dtype=torch.bool,
                                 device=dev)}


def _swap_sweep(ctx, tg, twin, stbl, t_valid, row_tabu, row_prev, row_next,
                row_self, row_selfT, cfg, utils):
    """Family C: swap each target's customer with every other stop's,
    [I, T, N]; both sides windowed."""
    tw = bool(utils["time_windowed"])
    w = cfg.window
    s_c = ctx["c"]                                            # [I, N]
    sg = {k: v[:, None, :] for k, v in _columns(stbl).items()}  # [I, 1, N]

    def col(name):
        return tg[name][..., None]                            # [I, T, 1]

    if tw:
        # side 1: the target's slot gets stop j's customer
        post1 = torch.maximum(col("postprev") + sg["ct"], sg["fl"])
        u1 = post1 - col("p")
        d_at1 = _relu(post1 - sg["ce"]) - col("late")
        sfx1, conv1 = _suffix_window(twin, u1, tw, w)
        d_end1 = torch.where((tg["pos"] == tg["len"] - 1)[..., None],
                             _relu(post1 - col("w1")) - col("ot"), 0)
        # side 2: stop j's slot gets the target's customer
        post2 = torch.maximum(sg["postprev"] + col("ct"), col("fl"))
        u2 = post2 - sg["p"]
        d_at2 = _relu(post2 - col("ce")) - sg["late"]
        sfx2, conv2 = _suffix_window(_insert_axis(_target_window(stbl), 1),
                                     u2, tw, w)
        d_end2 = torch.where(sg["pos"] == sg["len"] - 1,
                             _relu(post2 - sg["w1"]) - sg["ot"], 0)
        c_late = (d_at1 + sfx1 + d_end1) + (d_at2 + sfx2 + d_end2)
        conv_c = conv1 & conv2
    else:
        shape = (s_c.shape[0], tg["c"].shape[1], s_c.shape[1])
        c_late = torch.zeros(shape, dtype=_I32, device=s_c.device)
        conv_c = torch.ones(shape, dtype=torch.bool, device=s_c.device)

    def permute(rows, idx):                   # [I, T, L] at idx [I, N]
        return torch.gather(rows, -1, idx[:, None, :].expand(
            -1, rows.shape[1], -1).long())

    d1 = (permute(row_prev, s_c) + permute(row_next, s_c)
          - (tg["inleg"] + tg["outleg"])[..., None])
    d2 = (permute(row_selfT, sg["prev"][:, 0])
          + permute(row_self, sg["next"][:, 0])
          - (sg["inleg"] + sg["outleg"]))
    c_over = (_relu(col("load") - col("dem") + sg["dem"] - col("cap"))
              - _relu(tg["load"] - tg["cap"])[..., None]
              + _relu(sg["load"] - sg["dem"] + col("dem") - sg["cap"])
              - _relu(sg["load"] - sg["cap"]))
    c_valid = (t_valid[..., None]
               & (sg["v"] != col("v"))
               & (s_c[:, None, :] != col("c"))   # equal-value swap = no-op
               & ~cfg.frozen_cust
               & ~row_tabu[:, None, :])
    return {"c_hard": c_over, "c_late": c_late, "c_dist": d1 + d2,
            "c_valid": c_valid, "c_conv": conv_c}


def score_candidates(ctx, t_rows, t_valid, row_tabu, cfg: SweepConfig,
                     utils, tables=None):
    """Score every sweep candidate for the given target rows i32[I, T]
    (t_valid bool[I, T], row_tabu bool[I, N]).

    Returns a dict of per-family delta arrays (hard/late/dist), validity and
    lateness-exactness (`conv`) masks, plus the per-target values the winner
    decode needs. `late` entries are exact where `conv`, else a valid
    optimistic lower bound (see the module docstring)."""
    if tables is None:
        tables = build_tables(ctx, cfg, utils)
    stbl, route = tables
    trow = cb._take(stbl, t_rows)                             # [I, T, C]
    tg = _columns(trow)
    twin = _insert_axis(_target_window(trow), 2)              # [I, T, 1, ..]

    # dm rows of the target's neighbourhood
    dm, dmt = cfg.dm, cfg.dmT
    prev, nxt, c = tg["prev"].long(), tg["next"].long(), tg["c"].long()
    row_prev = dm[prev]                                       # dm[prev, :]
    row_next = dmt[nxt]                                       # dm[:, next]
    row_self = dm[c]                                          # dm[c, :]
    row_selfT = dmt[c]                                        # dm[:, c]
    splice = dm[prev, nxt].to(_I64)                           # dm[prev,next]

    out = _change_sweep(tg, twin, row_prev, row_next, ctx["counts"],
                        t_valid, cfg, utils)
    out.update(_vehicle_sweep(ctx, tg, t_rows, t_valid, route, row_self,
                              row_selfT, splice, cfg, utils))
    out.update(_swap_sweep(ctx, tg, twin, stbl, t_valid, row_tabu, row_prev,
                           row_next, row_self, row_selfT, cfg, utils))
    out.update({"t_rows": t_rows, "t_c": tg["c"], "s_c": ctx["c"]})
    return out


# --------------------------------------------------------------------------
# the sweep proposal
# --------------------------------------------------------------------------

def sample_targets(generators, ctx, free, cfg: SweepConfig):
    """T distinct tabu-free customer-group rows per island, drawn from the
    island's generator: (t_rows i32[I, T], t_valid bool[I, T])."""
    free_list, free_count = free
    fc = free_count[:, cfg.g_cust]                            # [I]
    lmax = cfg.cust_group_lmax
    dev = free_list.device
    slot = torch.arange(lmax, device=dev)
    u = torch.stack([torch.rand(lmax, generator=g, dtype=torch.float32,
                                device=dev) for g in generators])
    keys = u + torch.where(slot < fc[:, None], 0.0, 2.0)
    order = torch.argsort(keys, dim=-1, stable=True)[:, :cfg.targets]
    t_valid = ((torch.arange(cfg.targets, device=dev) < fc[:, None])
               & ~ctx["base_over"][:, None])
    t_slots = torch.gather(free_list[:, cfg.g_cust], 1, order)
    return cfg.row_of_cust_slot[t_slots.long()], t_valid


def tabu_rows(tabu_masks, cfg: SweepConfig, n_islands):
    """bool[I, N]: stop rows whose customer slot is tabu. An OR over slots:
    the member table's pad slots alias row 0 with False and must not erase
    a real True, so slot hits are counted, not written."""
    n = cfg.n_rows
    dev = cfg.row_of_cust_slot.device
    if tabu_masks is None:
        return torch.zeros((n_islands, n), dtype=torch.bool, device=dev)
    hits = (tabu_masks[:, cfg.g_cust] & cfg.cust_slot_valid).to(_I32)
    return torch.zeros((n_islands, n), dtype=_I32, device=dev).index_add_(
        1, cfg.row_of_cust_slot.long(), hits) > 0


def _select_winner(sc, cfg: SweepConfig, utils):
    """Lexicographic winner over all families (ties to the lowest flat
    index: family A before B before C, row-major inside a family). Returns
    (family, target index, candidate index, any_valid), each [I]."""
    ni, t = sc["t_rows"].shape
    n = cfg.n_rows
    lc = utils["n_stops"]
    kk = utils["k_vehicles"]

    def keyrow(f):
        k3 = torch.stack([sc[f + "_hard"].to(_I64), sc[f + "_late"].to(_I64),
                          sc[f + "_dist"].to(_I64)], dim=-1)
        return torch.where(sc[f + "_valid"][..., None], k3,
                           _STUB).reshape(ni, -1, 3)

    keys_all = torch.cat([keyrow("a"), keyrow("b"), keyrow("c")], dim=1)
    best = lexico.lex_argmin(keys_all)                        # [I]
    n_a, n_b = t * lc, t * kk
    fam = torch.where(best < n_a, 0, torch.where(best < n_a + n_b, 1, 2))
    off = best - torch.where(fam == 0, 0,
                             torch.where(fam == 1, n_a, n_a + n_b))
    per = torch.where(fam == 0, lc, torch.where(fam == 1, kk, n))
    isl = torch.arange(ni, device=best.device)
    any_valid = keys_all[isl, best, 0] != _STUB
    return fam, off // per, off % per, any_valid


def _exact_rescore(ctx, delta, any_valid, utils):
    """i32[I, 3] exact delta row of the winner (the narrow sorted-merge
    path), INT32_MAX-stubbed when it is over the route cap, the base is, or
    no candidate was valid — the accept decision never trusts a windowed
    bound."""
    parts = cb._delta_parts_sorted(ctx, delta, utils)
    d_hard = (1000 * (parts["new_dups"] - ctx["dups"])
              + parts["d_over"]).to(_I32)
    exact = torch.stack([d_hard, parts["d_late"].to(_I32),
                         parts["d_dist"].to(_I32)], dim=-1)
    bad = parts["over_cap"] | ctx["base_over"] | ~any_valid
    return torch.where(bad[:, None], _STUB, exact)


def propose_from_targets(ctx, t_rows, t_valid, row_tabu, cfg: SweepConfig,
                         utils):
    """The deterministic half of `propose`: score all candidates of the
    given targets, pick the lexicographic winner, re-score it exactly, and
    return (winner_delta, exact_int_row i32[I, 3], tabu_info, stats).

    The winner delta ({"positions", "values", "valid"} leaves [I, 2]) is a
    narrow delta for `moves.apply_delta` / `update_ctx`; `exact` is
    INT32_MAX-stubbed when no valid candidate exists (accept-if-<=0 then
    rejects)."""
    n = cfg.n_rows
    nd = utils["n_locations"] - utils["n_stops"]
    kk = utils["k_vehicles"]
    sc = score_candidates(ctx, t_rows, t_valid, row_tabu, cfg, utils)
    fam, ti, vi, any_valid = _select_winner(sc, cfg, utils)

    def pick(x, i):                                           # [I, X] at [I]
        return torch.gather(x, 1, i[:, None].long())[:, 0]

    w_row = pick(sc["t_rows"], ti).long()
    w_c_old = pick(sc["t_c"], ti)
    in_n = vi < n
    vi_c = torch.clamp(vi, max=n - 1)
    j_c = torch.where(in_n, pick(sc["s_c"], vi_c), 0)         # family C
    val1 = torch.where(fam == 0, nd + vi,
                       torch.where(fam == 1, vi, j_c)).to(_I32)
    pos1 = torch.where(fam == 1, cfg.veh_var[w_row], cfg.cust_var[w_row])
    pos2 = torch.where(fam == 2, cfg.cust_var[vi_c], pos1)
    delta = {
        "positions": torch.stack([pos1, pos2], dim=-1).to(_I32),
        "values": torch.stack([val1, w_c_old], dim=-1).to(cfg.float_dtype),
        "valid": torch.stack([any_valid, (fam == 2) & any_valid], dim=-1),
    }
    exact = _exact_rescore(ctx, delta, any_valid, utils)

    # tabu info: the winner's touched group slots (the reference pushes
    # touched ids during sampling, `mover.rs:75-96`), and its affected
    # vehicles (pre-update ids; <= 2 by construction)
    slot1 = torch.where(fam == 1, cfg.slot_of_row_veh[w_row],
                        cfg.slot_of_row_cust[w_row])
    slot2 = torch.where(fam == 2, cfg.slot_of_row_cust[vi_c], slot1)
    av_a = pick(ctx["v"], w_row)
    v_of_vi = torch.where(in_n, pick(ctx["v"], vi_c), 0)
    av_b = torch.where(fam == 1, vi, torch.where(fam == 2, v_of_vi, kk))
    info = {
        "group": torch.where(fam == 1, cfg.g_veh, cfg.g_cust).to(_I32),
        "positions": torch.stack([slot1, slot2], dim=-1).to(_I32),
        "count": torch.where(fam == 2, 2, 1).to(_I32),
        "av": torch.stack([av_a, av_b.to(_I32)], dim=-1),
    }

    def total(m):
        return torch.sum(m, dim=(1, 2), dtype=_I64)

    stats = {
        "n_scored": (total(sc["a_valid"]) + total(sc["b_valid"])
                     + total(sc["c_valid"])),
        "n_nonconv": (total(sc["a_valid"] & ~sc["a_conv"])
                      + total(sc["c_valid"] & ~sc["c_conv"])),
    }
    return delta, exact, info, stats


def propose(generators, ctx, free, tabu_masks, cfg: SweepConfig, utils):
    """Sample T targets per island from its generator (tabu-free customer
    slots), then `propose_from_targets`. `free` is `MoverConfig.tabu_free`'s
    pair, `tabu_masks` its `tabu_masks` (None without tabu)."""
    t_rows, t_valid = sample_targets(generators, ctx, free, cfg)
    row_tabu = tabu_rows(tabu_masks, cfg, t_rows.shape[0])
    return propose_from_targets(ctx, t_rows, t_valid, row_tabu, cfg, utils)


def exact_score_row(ctx, exact_ints, utils):
    """f64[I, 3] score row of each island's winner, computed exactly from
    the ctx's integer sums + the winner's exact integer deltas (bit-equal
    to `ctx_score_row` of the post-accept ctx); the stub row when the
    winner is stubbed. Used by acceptance rules that compare against stored
    f64 scores (LateAcceptance's ring)."""
    f64 = torch.float64
    hard = (1000.0 * ctx["dups"].to(f64) + ctx["sum_overflow"].to(f64)
            + exact_ints[..., 0].to(f64))
    medium = (ctx["sum_late"] + exact_ints[..., 1]).to(f64)
    soft = (ctx["sum_dist"] + exact_ints[..., 2]).to(f64) / 1000.0
    row = torch.stack([hard, medium, soft], dim=-1)
    bad = (exact_ints[..., 0] == _STUB) | ctx["base_over"]
    return torch.where(bad[..., None],
                       lexico.stub_score_row(3, device=row.device), row)
