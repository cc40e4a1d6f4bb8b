"""VRP cotwin + score functions — the flagship workload.

Counterpart of `greyjack_tpu/models/vrp/cotwin_builder.py` (reference
`examples/vrp/src/persistence/cotwin_builder.rs` and the fused constraint
`score/incremental_score_calculator.rs:32-142`):

  hard   = 1000 * duplicate-stops + capacity overflow
  medium = time-window lateness (+ work-day overtime)
  soft   = total route distance

Shapes: the plain path scores a population (leading axis P); the delta path
keeps one ctx per island (leading axis I) and analyses deltas shaped
[I, M, K] (M neighbours per island). The ctx carries per-vehicle route
buffers [K, R] in stable (vehicle, stop-index) order, payload columns
(customer, service, window floor / end, outgoing chain leg) and packed
per-stop / per-vehicle lookup rows; see the JAX module's section comment for
the design. Every integer result is bit-equal to the JAX package's.
"""

from __future__ import annotations

import numpy as np
import torch

from greyjack_tpu_torch.cotwin import Cotwin, CotwinBuilderBase
from greyjack_tpu_torch.variables import GJInteger
from greyjack_tpu_torch.score_calculation.scores import HardMediumSoftScore
from greyjack_tpu_torch.score_calculation.score_calculators import (
    PlainScoreCalculator,
    IncrementalScoreCalculator,
)
from greyjack_tpu_torch.ops import segments, routes, join, moves, lexico
from greyjack_tpu_torch.utils.math_utils import true_div

_I32 = torch.int32
_I64 = torch.int64


class CotStop:
    def __init__(self, vehicle_id, customer_id):
        self.vehicle_id = vehicle_id
        self.customer_id = customer_id

    def to_vec(self):
        return [("vehicle_id", self.vehicle_id), ("customer_id", self.customer_id)]


class CotCustomer:
    def __init__(self, customer_id, demand, time_window_start, time_window_end,
                 service_time):
        self._fields = [
            ("customer_id", customer_id),
            ("demand", demand),
            ("time_window_start", time_window_start),
            ("time_window_end", time_window_end),
            ("service_time", service_time),
        ]

    def to_vec(self):
        return list(self._fields)


class CotVehicle:
    def __init__(self, vehicle_id, capacity, depot_vec_id, work_day_start,
                 work_day_end):
        self._fields = [
            ("vehicle_id", vehicle_id),
            ("capacity", capacity),
            ("depot_vec_id", depot_vec_id),
            ("work_day_start", work_day_start),
            ("work_day_end", work_day_end),
        ]

    def to_vec(self):
        return list(self._fields)


def _take(table, idx):
    """Per-island row gather: table [I, X, ...], idx int[I, ...] ->
    [I, ..., ...] with out[i, ...] = table[i, idx[i, ...]]."""
    i = table.shape[0]
    ar = torch.arange(i, device=idx.device).view((i,) + (1,) * (idx.dim() - 1))
    return table[ar, idx.long()]


def _lower(n, device):
    """[n, n] bool: entry (k, k') is True when k' < k (an earlier slot)."""
    idx = torch.arange(n, device=device)
    return idx[None, :] < idx[:, None]


def _first_true(mask):
    """Index of the first True along the last axis (0 when none), i32."""
    return torch.argmax(mask.to(_I32), dim=-1).to(_I32)


# --- constraints ------------------------------------------------------------

def build_common(planning, facts, utils):
    """Prescoring for a population: stable vehicle sort + one fused route
    walk + duplicate count + loads. The fast walk sums exact integer-milli
    distances; `exact_fp_scores=True` switches to the walk that folds the
    f64 distances in the reference's sequential order
    (`routes.vrp_routes`), bit-equal to the JAX package's exact branch."""
    stops = planning["planning_stops"]
    v = stops["vehicle_id"]
    c = stops["customer_id"]
    sorted_v, perm = routes.sort_stops_by_vehicle(v)
    sorted_c = join.apply_permutation(c, perm)
    cust_rows = utils["cust_packed"][sorted_c.long()]
    dups = segments.count_minus_n_unique(c, utils["n_locations"])
    if utils["exact_fp_scores"]:
        dist, lateness = routes.vrp_routes(
            sorted_v, sorted_c, utils["distance_matrix"],
            utils["vehicle_depot_ids"], utils["k_vehicles"],
            utils["work_day_start_k"], utils["work_day_end_k"],
            cust_rows if utils["time_windowed"] else None)
    else:
        dist, lateness = routes.vrp_routes_packed(
            sorted_v, sorted_c, utils["dm_flat_milli"], utils["n_locations"],
            utils["vehicle_depot_ids"], utils["work_day_start_k"],
            utils["work_day_end_k"], cust_rows, utils["time_windowed"],
            dm_at=utils.get("dm_at"))
    loads = segments.segment_sum(cust_rows[..., 0], sorted_v,
                                 utils["k_vehicles"])
    return {
        "route_distance": dist,
        "route_lateness": lateness,
        "dup_count": dups,
        "vehicle_loads": loads,
    }


def no_duplicating_stops_constraint(planning, facts, utils):
    return (1000.0 * utils["dup_count"], 0.0, 0.0)


def capacity_constraint(planning, facts, utils):
    over = torch.clamp(utils["vehicle_loads"] - utils["capacities"], min=0)
    overflow = torch.sum(over, dim=-1, dtype=_I64).to(torch.float64)
    return (overflow, 0.0, 0.0)


def minimize_distance(planning, facts, utils):
    return (0.0, 0.0, utils["route_distance"])


def late_arrival_penalty(planning, facts, utils):
    return (0.0, utils["route_lateness"], 0.0)


# --- delta (incremental) kernels ---------------------------------------------

_PAYLOAD_KEYS = ("r_stop", "r_c", "r_ct", "r_floor", "r_ce")
_ALL_BUF_KEYS = _PAYLOAD_KEYS + ("r_leg",)
_SMALL_DELTA_MAX = 4   # widest delta `_delta_parts` sends to the shift-merge


def _route_cap(n_stops, k):
    return int(min(n_stops, max(48, -(-4 * n_stops // k))))


def _payload_from_customers(cids, utils):
    """(c, service, floor=tw_start+service, tw_end) for customer ids."""
    crows = utils["cust_packed"][cids.long()]
    cs = crows[..., 1]
    ce = crows[..., 2]
    ct = crows[..., 3]
    return cids, ct, cs + ct, ce


def _late_from_buffers(bufs, valid, length, veh_ids, utils):
    """Time-window lateness per route row, prefix form:
    post_j = P_j + max(w0, cummax_{i<=j}(floor_i - P_i)), P = inclusive
    cumsum of service (i32, as in the JAX package)."""
    acc = utils["acc_dtype"]
    big = 1 << 30
    ct = torch.where(valid, bufs["r_ct"], 0)
    floor = torch.where(valid, bufs["r_floor"], -big)
    w0 = utils["work_day_start_k"][veh_ids.long()].to(_I32)
    w1 = utils["work_day_end_k"][veh_ids.long()].to(_I32)
    p = torch.cumsum(ct, dim=-1, dtype=_I32)
    post = p + torch.maximum(w0[..., None],
                             torch.cummax(floor - p, dim=-1).values)
    late = torch.where(valid, torch.clamp(post - bufs["r_ce"], min=0), 0)
    has = length > 0
    overtime = torch.where(has, torch.clamp(post[..., -1] - w1, min=0), 0)
    return torch.sum(late, dim=-1, dtype=acc) + overtime.to(acc)


def _buffer_metrics(bufs, veh_ids, utils, return_legs=False):
    """Per-route metrics straight off payload buffers [..., A, W] (rows
    sorted by r_stop, sentinel n_stops padding as a suffix); veh_ids
    int[..., A]. Returns (dist acc[..., A], late acc[..., A],
    length i32[..., A]) plus the masked chain legs when `return_legs`."""
    acc = utils["acc_dtype"]
    l = utils["n_locations"]
    dmf = utils["dm_flat_milli"]
    n = utils["n_stops"]
    key = bufs["r_stop"]
    rc = bufs["r_c"]
    wd = key.shape[-1]
    valid = key < n
    length = torch.sum(valid, dim=-1, dtype=_I32)
    has = length > 0

    legs = dmf[(rc[..., :-1] * l + rc[..., 1:]).long()]
    legs = torch.where(valid[..., 1:], legs, 0)
    depots = utils["vehicle_depot_ids"][veh_ids.long()].to(_I32)
    first = rc[..., 0]
    last_onehot = (torch.arange(wd, device=rc.device)
                   == (length[..., None] - 1))
    last = torch.sum(torch.where(last_onehot, rc, 0), dim=-1, dtype=_I32)
    ends = (dmf[(depots * l + first).long()].to(acc)
            + dmf[(last * l + depots).long()].to(acc))
    dist = torch.where(has, ends + torch.sum(legs, dim=-1, dtype=acc), 0)

    if utils["time_windowed"]:
        late_total = _late_from_buffers(bufs, valid, length, veh_ids, utils)
    else:
        late_total = torch.zeros(length.shape, dtype=acc, device=rc.device)
    if return_legs:
        return dist, late_total, length, legs
    return dist, late_total, length


def _pack32(x):
    if x.dtype == _I32:
        return x
    return torch.clamp(x, -(2 ** 31) + 1, 2 ** 31 - 1).to(_I32)


def build_delta_ctx(planning, facts, utils):
    """O(N) base pass per island: payload route buffers + per-vehicle
    metrics + totals. planning stops [I, N] -> ctx with leading axis I.

    The route buffers are gathered, not scattered: stops are stably sorted
    by vehicle, so route k's slot j holds sorted stop `start[k] + j`."""
    stops = planning["planning_stops"]
    v = stops["vehicle_id"].to(_I32)
    c = stops["customer_id"].to(_I32)
    ni, n = v.shape
    dev = v.device
    l = utils["n_locations"]
    k = utils["k_vehicles"]
    r = utils["route_cap"]
    cust_packed = utils["cust_packed"]

    counts = torch.zeros((ni, l), dtype=_I32, device=dev).scatter_add_(
        1, c.long(), torch.ones_like(c))
    dups = (n - torch.sum(counts > 0, dim=-1)).to(_I32)

    sorted_v, perm = routes.sort_stops_by_vehicle(v)
    kk = torch.arange(k, dtype=_I32, device=dev).expand(ni, k).contiguous()
    start = torch.searchsorted(sorted_v, kk)                 # [I, K]
    end = torch.searchsorted(sorted_v, kk, right=True)
    src = start[..., None] + torch.arange(r, device=dev)     # [I, K, R]
    in_route = src < end[..., None]
    src = torch.clamp(src, max=n - 1).reshape(ni, k * r)

    def route_buf(col_sorted, fill):
        vals = torch.gather(col_sorted, 1, src).reshape(ni, k, r)
        return torch.where(in_route, vals, fill)

    c_sorted = join.apply_permutation(c, perm)
    cid, ct, floor, ce = _payload_from_customers(c_sorted, utils)
    bufs = {"r_stop": route_buf(perm.to(_I32), n)}
    for name, col in (("r_c", cid), ("r_ct", ct), ("r_floor", floor),
                      ("r_ce", ce)):
        bufs[name] = route_buf(col, 0)

    posi = torch.arange(n, dtype=_I32, device=dev)
    rank = posi - torch.gather(start.to(_I32), 1,
                               torch.clamp(sorted_v, max=k - 1).long())
    rank_c = torch.clamp(rank, max=r - 1)
    # perm is a permutation, so every target is written exactly once
    pos = torch.zeros((ni, n), dtype=_I32, device=dev).scatter_(
        1, perm, rank_c)

    veh_ids = torch.arange(k, dtype=_I32, device=dev).expand(ni, k)
    dist, late, length, legs = _buffer_metrics(bufs, veh_ids, utils,
                                               return_legs=True)
    bufs["r_leg"] = torch.cat(
        [legs, torch.zeros((ni, k, 1), dtype=legs.dtype, device=dev)], dim=-1)
    dem = cust_packed[c.long(), 0]
    load = torch.zeros((ni, k), dtype=_I32, device=dev).scatter_add_(
        1, v.long(), dem)
    overflow = torch.clamp(load - utils["capacities"], min=0).to(_I64)
    true_counts = torch.zeros((ni, k), dtype=_I32, device=dev).scatter_add_(
        1, v.long(), torch.ones_like(v))
    base_over = torch.any(true_counts > r, dim=-1)

    def per_island(x):
        return x.expand(ni, k)

    return {"v": v, "c": c, "counts": counts, "dups": dups, "pos": pos,
            "base_over": base_over,
            **bufs,
            "dist": dist, "late": late, "load": load, "len": length,
            "row_pack": torch.stack([v, c, pos, dem], dim=-1),
            "veh_pack": torch.stack([
                per_island(utils["work_day_start_k"].to(_I32)),
                per_island(utils["work_day_end_k"].to(_I32)),
                length,
                _pack32(dist),
                _pack32(late),
                load,
                per_island(utils["capacities"]),
                per_island(utils["vehicle_depot_ids"].to(_I32)),
            ], dim=-1),
            "sum_dist": torch.sum(dist, dim=-1, dtype=_I64),
            "sum_late": torch.sum(late, dim=-1, dtype=_I64),
            "sum_overflow": torch.sum(overflow, dim=-1)}


def _delta_common(ctx, delta, utils):
    """Per-neighbour scalar analysis: patched (vehicle, customer) values,
    affected-route table, row -> route-slot maps. ctx leaves [I, ...];
    delta leaves [I, M, K], already deduped. Outputs [I, M, ...]."""
    schema = utils["delta_schema"]
    k = utils["k_vehicles"]
    n = ctx["v"].shape[-1]
    kd = delta["positions"].shape[-1]
    dev = delta["positions"].device

    rc2 = schema["var_rowcol"][delta["positions"].long()]
    rows = rc2[..., 0]
    cols = rc2[..., 1]
    valid = delta["valid"]
    nv = torch.round(delta["values"]).to(_I32)
    is_veh = cols == 0

    rid = torch.where(valid, rows, n)
    lower = _lower(kd, dev)
    eqr = rid[..., :, None] == rid[..., None, :]
    rep = valid & ~torch.any(eqr & lower, dim=-1)
    veh_match = eqr & is_veh[..., None, :] & valid[..., None, :]
    cust_match = eqr & (~is_veh)[..., None, :] & valid[..., None, :]
    rp_row = _take(ctx["row_pack"], rows)
    old_v = rp_row[..., 0]
    old_c = rp_row[..., 1]
    slot_of_row = rp_row[..., 2]
    dem_old = rp_row[..., 3]
    pick_v = torch.gather(nv, -1, _first_true(veh_match).long())
    pick_c = torch.gather(nv, -1, _first_true(cust_match).long())
    new_v = torch.where(torch.any(veh_match, dim=-1), pick_v, old_v)
    new_c = torch.where(torch.any(cust_match, dim=-1), pick_c, old_c)

    d_unique = segments.nunique_delta(ctx["counts"], old_c, new_c, rep)
    new_dups = ctx["dups"][:, None] - d_unique

    veh_changed = rep & (new_v != old_v)
    stay = rep & ~veh_changed

    av = torch.cat([torch.where(rep, old_v, k),
                    torch.where(veh_changed, new_v, k)], dim=-1)
    eqa = av[..., :, None] == av[..., None, :]
    arep = (av < k) & ~torch.any(eqa & _lower(2 * kd, dev), dim=-1)
    av_safe = torch.clamp(av, max=k - 1)
    a_of_row = _first_true((av[..., None, :] == old_v[..., :, None])
                           & arep[..., None, :])
    a_of_new = _first_true((av[..., None, :] == new_v[..., :, None])
                           & arep[..., None, :])
    return {"rows": rows, "rep": rep, "valid": valid, "old_v": old_v,
            "old_c": old_c, "new_v": new_v, "new_c": new_c,
            "dem_old": dem_old,
            "veh_changed": veh_changed, "stay": stay, "av": av,
            "arep": arep, "av_safe": av_safe, "a_of_row": a_of_row,
            "a_of_new": a_of_new, "slot_of_row": slot_of_row,
            "new_dups": new_dups}


def _drop_neighbour_axis(tree):
    if isinstance(tree, dict):
        return {key: _drop_neighbour_axis(x) for key, x in tree.items()}
    return tree[:, 0]


def _delta_parts_sorted(ctx, delta, utils):
    """Delta analysis by a sorted merge: patch changed customers at their
    known slots, clear moved-away stops, append moved-in stops, sort each
    affected route by stop index, and re-walk it. Delta leaves are
    [I, P, K] (P neighbours per island; outputs [I, P, ...]) or [I, K] (one
    delta per island, as `update_ctx` and the sweep's exact re-score pass
    it; outputs [I, ...]). The width dispatch `_delta_parts` sends deltas
    wider than `_SMALL_DELTA_MAX` here.

    The sort is stable here, but only sentinel keys (n_stops) can tie, and
    `update_ctx` zeroes every sentinel slot's payload — the same guarantee
    that makes the JAX package's unstable sort safe."""
    if delta["positions"].dim() == 2:
        return _drop_neighbour_axis(_delta_parts_sorted(
            ctx, {key: x[:, None] for key, x in delta.items()}, utils))
    delta = moves.dedupe_delta(delta)
    c = _delta_common(ctx, delta, utils)
    r = utils["route_cap"]
    n = ctx["v"].shape[-1]
    kd = delta["positions"].shape[-1]
    dev = delta["positions"].device

    rows, rep = c["rows"], c["rep"]
    old_v, old_c = c["old_v"], c["old_c"]
    new_v, new_c = c["new_v"], c["new_c"]
    veh_changed = c["veh_changed"]
    av, arep, av_safe = c["av"], c["arep"], c["av_safe"]
    a_of_row, slot_of_row = c["a_of_row"], c["slot_of_row"]
    dem_old = c["dem_old"]
    a2 = 2 * kd

    dem_new = utils["cust_packed"][new_c.long(), 0]
    npay = _payload_from_customers(new_c, utils)
    base = {name: _take(ctx[name], av_safe) for name in _PAYLOAD_KEYS}
    # per-row [A2, R] cell masks (compare-select, no scatter)
    cell = ((torch.arange(a2, device=dev)[:, None]
             == a_of_row[..., None, None])
            & (torch.arange(r, device=dev)
               == slot_of_row[..., None, None]))            # [I, P, KD, A2, R]
    for kk in range(kd):
        clear = cell[..., kk, :, :] & veh_changed[..., kk, None, None]
        patch = cell[..., kk, :, :] & rep[..., kk, None, None]
        base["r_stop"] = torch.where(clear, n, base["r_stop"])
        for name, col in zip(_PAYLOAD_KEYS[1:], npay):
            base[name] = torch.where(patch, col[..., kk, None, None],
                                     base[name])

    ins_here = (veh_changed[..., None, :]
                & (new_v[..., None, :] == av[..., None]))   # [I, P, A2, KD]
    ins = {"r_stop": torch.where(ins_here, rows[..., None, :], n)}
    for name, col in zip(_PAYLOAD_KEYS[1:], npay):
        ins[name] = col[..., None, :].expand(ins_here.shape)

    operands = {name: torch.cat([base[name], ins[name]], dim=-1)
                for name in _PAYLOAD_KEYS}
    order = torch.sort(operands["r_stop"], dim=-1, stable=True).indices
    bufs = {name: torch.gather(x, -1, order) for name, x in operands.items()}

    dist, late, length, legs = _buffer_metrics(bufs, av_safe, utils,
                                               return_legs=True)
    bufs["r_leg"] = torch.cat(
        [legs, torch.zeros(legs.shape[:-1] + (1,), dtype=legs.dtype,
                           device=dev)], dim=-1)

    load = _take(ctx["load"], av_safe) + _load_change(
        old_v, new_v, av, veh_changed, rep, dem_old, dem_new)
    d_dist, d_late, d_over = _route_deltas(ctx, av_safe, arep, dist, late,
                                           load, utils)
    over_cap = torch.any(arep & (length > r), dim=-1)
    return {"rows": rows, "rep": rep, "new_v": new_v, "new_c": new_c,
            "old_c": old_c, "av": av, "arep": arep, "bufs": bufs,
            "dist": dist, "late": late, "load": load, "len": length,
            "d_dist": d_dist, "d_late": d_late, "d_over": d_over,
            "new_dups": c["new_dups"], "over_cap": over_cap}


def _load_change(old_v, new_v, av, veh_changed, rep, dem_old, dem_new):
    """i32[..., A2]: each affected route's load change, from the rep rows'
    demands (O(K) arithmetic, no demand payload in the merge)."""
    is_old = old_v[..., None, :] == av[..., None]            # [..., A2, KD]
    is_new = new_v[..., None, :] == av[..., None]
    vc = veh_changed[..., None, :]
    contrib = (
        torch.where(vc & is_old, -dem_old[..., None, :], 0)
        + torch.where(vc & is_new, dem_new[..., None, :], 0)
        + torch.where(rep[..., None, :] & ~vc & is_old,
                      (dem_new - dem_old)[..., None, :], 0))
    return torch.sum(contrib, dim=-1, dtype=_I32)


def _route_deltas(ctx, av_safe, arep, dist, late, load, utils):
    """(d_dist, d_late, d_over) i64[...]: the distinct affected routes'
    distance, lateness and overflow changes against the ctx."""
    cap_a = utils["capacities"][av_safe.long()]
    d_dist = torch.sum(torch.where(arep, dist - _take(ctx["dist"], av_safe),
                                   0), dim=-1, dtype=_I64)
    d_late = torch.sum(torch.where(arep, late - _take(ctx["late"], av_safe),
                                   0), dim=-1, dtype=_I64)
    d_over = torch.sum(torch.where(
        arep,
        torch.clamp(load - cap_a, min=0).to(_I64)
        - torch.clamp(_take(ctx["load"], av_safe) - cap_a, min=0).to(_I64),
        0), dim=-1)
    return d_dist, d_late, d_over


def _delta_parts_small(ctx, delta, utils):
    """Narrow-delta analysis (KD <= `_SMALL_DELTA_MAX`) by shift-merge with
    carried-leg accounting, batched over islands and neighbours: ctx leaves
    [I, ...], delta leaves [I, P, K], outputs [I, P, ...].

    Removals close gaps and insertions open them, so every surviving slot
    moves by a shift in [-KD, KD]: the new route buffers are 2*KD+1 masked
    rolls of the old ones plus a one-hot insert (no sort, no scatter).
    Every stop carries its outgoing leg through the merge; only the O(KD)
    pairs next to an edit can change, and one consolidated distance-matrix
    gather of [3*KD + 2*A2] entries per neighbour corrects them (a clean
    pair flagged dirty corrects by zero). Lateness is the prefix form
    post = P + max(w0, cummax(floor - P)), P = cumsum(service)."""
    delta = moves.dedupe_delta(delta)
    r = utils["route_cap"]
    n = ctx["v"].shape[-1]
    l = utils["n_locations"]
    dmf = utils["dm_flat_milli"]
    acc = utils["acc_dtype"]
    kd = delta["positions"].shape[-1]
    dev = delta["positions"].device
    a2 = 2 * kd
    idxa = torch.arange(a2, device=dev)
    jgrid = torch.arange(r, dtype=_I32, device=dev)

    c = _delta_common(ctx, delta, utils)
    rows, rep = c["rows"], c["rep"]
    old_v, old_c = c["old_v"], c["old_c"]
    new_v, new_c = c["new_v"], c["new_c"]
    veh_changed, stay = c["veh_changed"], c["stay"]
    av, arep, av_safe = c["av"], c["arep"], c["av_safe"]
    a_of_row, a_of_new = c["a_of_row"], c["a_of_new"]
    slot_of_row = c["slot_of_row"]

    base = {name: _take(ctx[name], av_safe)
            for name in _ALL_BUF_KEYS}                       # [I, P, A2, R]
    # per-row one-hot grids [I, P, KD, A2, R]: the row's own cell
    row_at = ((idxa[:, None] == a_of_row[..., None, None])
              & (jgrid == slot_of_row[..., None, None]))

    # patch stay rows' customer payloads in place
    npay = _payload_from_customers(new_c, utils)
    pm = row_at & stay[..., None, None]
    pm_any = torch.any(pm, dim=-3)
    for name, col in zip(_PAYLOAD_KEYS[1:], npay):
        pval = torch.sum(torch.where(pm, col[..., None, None], 0), dim=-3,
                         dtype=_I32)
        base[name] = torch.where(pm_any, pval, base[name])

    # shifts: removals close gaps, insertions open them
    cleared = torch.any(row_at & veh_changed[..., None, None], dim=-3)
    ins_into = (veh_changed[..., None]
                & (idxa == a_of_new[..., None]))             # [I, P, KD, A2]
    key_gt_row = rows[..., None, None] < base["r_stop"][..., None, :, :]
    ins_before = torch.sum(ins_into[..., None] & key_gt_row, dim=-3,
                           dtype=_I32)
    cleared_i = cleared.to(_I32)
    rem_before = torch.cumsum(cleared_i, dim=-1, dtype=_I32) - cleared_i
    shift = ins_before - rem_before                          # [I, P, A2, R]
    survives = ~cleared

    # insert positions: survivors with a smaller key + earlier same-route
    # inserts
    ins_key = torch.where(veh_changed, rows, n)
    same_new = (veh_changed[..., :, None] & veh_changed[..., None, :]
                & (a_of_new[..., :, None] == a_of_new[..., None, :]))
    ins_rank_ins = torch.sum(
        same_new & (ins_key[..., None, :] < ins_key[..., :, None]), dim=-1,
        dtype=_I32)
    ins_rank_base = torch.sum(
        ins_into[..., None] & survives[..., None, :, :] & ~key_gt_row,
        dim=(-2, -1), dtype=_I32)
    ins_pos = ins_rank_base + ins_rank_ins                   # [I, P, KD]

    # merge: 2*KD+1 masked rolls, then the one-hot insert; a source shifted
    # past either end (a tail sentinel pushed off, over-cap growth) is
    # dropped, not wrapped around
    received = torch.zeros(shift.shape, dtype=_I32, device=dev)
    merged = {name: torch.zeros_like(base[name]) for name in _ALL_BUF_KEYS}
    for s in range(-kd, kd + 1):
        m = survives & (shift == s)
        keep = (jgrid >= s) if s >= 0 else (jgrid < r + s)
        received = received + torch.where(
            keep, torch.roll(m.to(_I32), s, dims=-1), 0)
        for name in _ALL_BUF_KEYS:
            merged[name] = merged[name] + torch.where(
                keep, torch.roll(torch.where(m, base[name], 0), s, dims=-1),
                0)
    im = (veh_changed[..., None, None]
          & (idxa[:, None] == a_of_new[..., None, None])
          & (jgrid == ins_pos[..., None, None]))            # [I, P, KD, A2, R]
    im_any = torch.any(im, dim=-3)
    ins_cols = dict(zip(_PAYLOAD_KEYS[1:], npay))
    ins_cols["r_stop"] = rows
    ins_cols["r_leg"] = torch.zeros_like(rows)
    bufs = {}
    for name in _ALL_BUF_KEYS:
        ival = torch.sum(torch.where(im, ins_cols[name][..., None, None], 0),
                         dim=-3, dtype=_I32)
        bufs[name] = torch.where(im_any, ival, merged[name])
    received = torch.where(im_any, 1, received)
    bufs["r_stop"] = torch.where(received > 0, bufs["r_stop"], n)

    # lengths and loads
    n_clr = torch.sum(cleared, dim=-1, dtype=_I32)
    n_ins = torch.sum(ins_into, dim=-2, dtype=_I32)
    length = _take(ctx["len"], av_safe) - n_clr + n_ins      # [I, P, A2]
    over_cap = torch.any(arep & (length > r), dim=-1)
    valid_j = jgrid < length[..., None]
    has = length > 0
    dem_old = utils["cust_packed"][old_c.long(), 0]
    dem_new = utils["cust_packed"][new_c.long(), 0]
    load = _take(ctx["load"], av_safe) + _load_change(
        old_v, new_v, av, veh_changed, rep, dem_old, dem_new)

    # distance: carried legs + dirty-pair corrections; three candidate
    # pairs per rep row (over-flagging a clean pair is harmless)
    shift_at_row = torch.sum(torch.where(row_at, shift[..., None, :, :], 0),
                             dim=(-2, -1), dtype=_I32)
    locus = slot_of_row + shift_at_row
    er = torch.cat([a_of_row, torch.where(veh_changed, a_of_new, a_of_row),
                    a_of_new], dim=-1)                       # [I, P, 3KD]
    el = torch.cat([locus - 1, torch.where(veh_changed, ins_pos - 1, locus),
                    ins_pos], dim=-1)
    ev = torch.cat([rep, rep, veh_changed], dim=-1)
    len_at = torch.sum(torch.where(idxa == er[..., None], length[..., None, :],
                                   0), dim=-1, dtype=_I32)
    ev = ev & (el >= 0) & (el <= len_at - 2)
    ekey = torch.where(ev, er * (r + 1) + el, -1)
    ii3 = torch.arange(3 * kd, device=dev)
    edup = torch.any((ekey[..., :, None] == ekey[..., None, :])
                     & ev[..., :, None] & ev[..., None, :]
                     & (ii3 < ii3[:, None]), dim=-1)
    ev = ev & ~edup

    on_route = idxa[:, None] == er[..., None, None]
    pair_l = on_route & (jgrid == el[..., None, None])       # [I, P, 3KD, A2, R]
    pair_r = on_route & (jgrid == el[..., None, None] + 1)
    r_c = bufs["r_c"][..., None, :, :]
    u = torch.sum(torch.where(pair_l, r_c, 0), dim=(-2, -1), dtype=_I32)
    v_right = torch.sum(torch.where(pair_r, r_c, 0), dim=(-2, -1), dtype=_I32)
    carried = torch.sum(torch.where(pair_l, bufs["r_leg"][..., None, :, :],
                                    0), dim=(-2, -1), dtype=_I32)

    depots = utils["vehicle_depot_ids"][av_safe.long()].to(_I32)
    first_c = bufs["r_c"][..., 0]
    last_c = torch.sum(torch.where(jgrid == length[..., None] - 1,
                                   bufs["r_c"], 0), dim=-1, dtype=_I32)
    gidx = torch.cat([
        torch.where(ev, u * l + v_right, 0),
        torch.where(has, depots * l + first_c, 0),
        torch.where(has, last_c * l + depots, 0),
    ], dim=-1)
    gvals = dmf[gidx.long()]   # the one consolidated distance-matrix gather
    leg_new = gvals[..., :3 * kd]
    start_leg = torch.where(has, gvals[..., 3 * kd:3 * kd + a2], 0)
    end_leg = torch.where(has, gvals[..., 3 * kd + a2:], 0)

    corr = torch.where(ev, leg_new - carried, 0)
    corr_by_route = torch.sum(
        torch.where(idxa == er[..., None], corr[..., None].to(acc), 0),
        dim=-2, dtype=acc)
    pairv = valid_j[..., :-1] & valid_j[..., 1:]
    chain = (torch.sum(torch.where(pairv, bufs["r_leg"][..., :-1], 0),
                       dim=-1, dtype=acc)
             + corr_by_route)
    dist = torch.where(has, start_leg.to(acc) + end_leg.to(acc) + chain, 0)

    # exact r_leg for ctx updates: patch dirty pairs, zero out-of-pair slots
    dirty = pair_l & ev[..., None, None]
    rl_patch = torch.sum(torch.where(dirty, leg_new[..., None, None], 0),
                         dim=-3, dtype=_I32)
    rl_dirty = torch.any(dirty, dim=-3)
    bufs["r_leg"] = torch.where(
        torch.nn.functional.pad(pairv, (0, 1), value=False),
        torch.where(rl_dirty, rl_patch, bufs["r_leg"]), 0)

    if utils["time_windowed"]:
        late = _late_from_buffers(bufs, valid_j, length, av_safe, utils)
    else:
        late = torch.zeros(length.shape, dtype=acc, device=dev)

    d_dist, d_late, d_over = _route_deltas(ctx, av_safe, arep, dist, late,
                                           load, utils)
    return {"rows": rows, "rep": rep, "new_v": new_v, "new_c": new_c,
            "old_c": old_c, "av": av, "arep": arep, "bufs": bufs,
            "dist": dist, "late": late, "load": load, "len": length,
            "d_dist": d_dist, "d_late": d_late, "d_over": d_over,
            "new_dups": c["new_dups"], "over_cap": over_cap}


def _delta_parts(ctx, delta, utils):
    """Width-dispatched delta analysis over [I, P, K] deltas: shift-merge
    for narrow deltas, sorted merge for wide ones. Both give the same
    buffers."""
    if delta["positions"].shape[-1] <= _SMALL_DELTA_MAX:
        return _delta_parts_small(ctx, delta, utils)
    return _delta_parts_sorted(ctx, delta, utils)


def score_delta(ctx, deltas, utils):
    """f64[I, P, 3] score rows of every island's neighbours from the
    per-neighbour delta analysis, bit-equal to the plain scorer. The
    requester's fallback when the fused kernel is statically ineligible
    (the JAX package vmaps it per neighbour)."""
    p = _delta_parts(ctx, deltas, utils)
    f64 = torch.float64
    hard = (1000.0 * p["new_dups"].to(f64)
            + (ctx["sum_overflow"][:, None] + p["d_over"]).to(f64))
    medium = (ctx["sum_late"][:, None] + p["d_late"]).to(f64)
    soft = true_div((ctx["sum_dist"][:, None] + p["d_dist"]).to(f64), 1000.0)
    row = torch.stack([hard, medium, soft], dim=-1)
    bad = p["over_cap"] | ctx["base_over"][:, None]
    return torch.where(bad[..., None],
                       lexico.stub_score_row(3, device=row.device), row)


def ctx_score_row(ctx, utils):
    """f64[I, 3] score of each island's base candidate from its exact
    integer sums (the stub row when the base is over the route cap)."""
    hard = (1000.0 * ctx["dups"].to(torch.float64)
            + ctx["sum_overflow"].to(torch.float64))
    medium = ctx["sum_late"].to(torch.float64)
    soft = true_div(ctx["sum_dist"].to(torch.float64), 1000.0)
    row = torch.stack([hard, medium, soft], dim=-1)
    stub = lexico.stub_score_row(3, device=row.device)
    return torch.where(ctx["base_over"][:, None], stub, row)


def ctx_int_totals(ctx, utils):
    """i64[I, 3] exact integer totals (1000*dups + overflow, lateness,
    distance milli); with int_scales [1, 1, 1000] they map to
    `ctx_score_row` bit-for-bit."""
    hard = 1000 * ctx["dups"].to(_I64) + ctx["sum_overflow"].to(_I64)
    return torch.stack([hard, ctx["sum_late"].to(_I64),
                        ctx["sum_dist"].to(_I64)], dim=-1)


def update_ctx(ctx, delta, utils):
    """Apply one accepted delta per island (leaves [I, K]) to the ctx;
    identity for an island whose delta has no valid entry (over-cap deltas
    are never accepted — their score is the stub).

    Every table patch is a compare-select over the K / A2 axis, so no two
    writes ever race; sentinel indices (n / k) never match."""
    p = _delta_parts_sorted(ctx, delta, utils)
    k = utils["k_vehicles"]
    l = utils["n_locations"]
    r = utils["route_cap"]
    n = ctx["v"].shape[-1]
    dev = ctx["v"].device
    rowsel = torch.where(p["rep"], p["rows"], n)
    vehsel = torch.where(p["arep"], p["av"], k)
    out = dict(ctx)

    iota_n = torch.arange(n, dtype=_I32, device=dev)
    iota_k = torch.arange(k, dtype=_I32, device=dev)
    iota_l = torch.arange(l, dtype=_I32, device=dev)

    mrow = iota_n[None, :, None] == rowsel[:, None, :]        # [I, N, KD]
    hit_row = torch.any(mrow, dim=-1)

    def _rowval(vals, old):
        v = torch.sum(torch.where(mrow, vals[:, None, :], 0), dim=-1,
                      dtype=old.dtype)
        return torch.where(hit_row, v, old)

    out["v"] = _rowval(p["new_v"], ctx["v"])
    out["c"] = _rowval(p["new_c"], ctx["c"])
    mold = iota_l[None, :, None] == torch.where(p["rep"], p["old_c"],
                                                l)[:, None, :]
    mnew = iota_l[None, :, None] == torch.where(p["rep"], p["new_c"],
                                                l)[:, None, :]
    cdt = ctx["counts"].dtype
    out["counts"] = (ctx["counts"] + torch.sum(mnew, dim=-1, dtype=cdt)
                     - torch.sum(mold, dim=-1, dtype=cdt))
    out["dups"] = p["new_dups"]

    mveh = iota_k[None, :, None] == vehsel[:, None, :]        # [I, K, A2]
    hit_veh = torch.any(mveh, dim=-1)
    new_stop_r = p["bufs"]["r_stop"][..., :r]
    valid_r = new_stop_r < n

    def _vehrows(rows_a2, old):                               # [I, A2, R]
        v = torch.sum(torch.where(mveh[..., None], rows_a2[:, None], 0),
                      dim=2, dtype=old.dtype)
        return torch.where(hit_veh[..., None], v, old)

    out["r_stop"] = _vehrows(new_stop_r, ctx["r_stop"])
    for name in _ALL_BUF_KEYS[1:]:
        out[name] = _vehrows(
            torch.where(valid_r, p["bufs"][name][..., :r], 0), ctx[name])
    # stops in every affected route may have shifted: rewrite their pos
    slot_idx = torch.arange(r, dtype=_I32, device=dev)
    stop_at = torch.where(valid_r & p["arep"][..., None], new_stop_r, n)
    mpos = iota_n[None, :, None, None] == stop_at[:, None]    # [I, N, A2, R]
    hit_pos = torch.any(mpos.flatten(2), dim=-1)
    pos_val = torch.sum(torch.where(mpos, slot_idx, 0).flatten(2), dim=-1,
                        dtype=ctx["pos"].dtype)
    out["pos"] = torch.where(hit_pos, pos_val, ctx["pos"])

    def _vehscal(val_a2, old):                                # [I, A2]
        v = torch.sum(torch.where(mveh, val_a2[:, None, :].to(old.dtype), 0),
                      dim=-1, dtype=old.dtype)
        return torch.where(hit_veh, v, old)

    out["dist"] = _vehscal(p["dist"], ctx["dist"])
    out["late"] = _vehscal(p["late"], ctx["late"])
    out["load"] = _vehscal(p["load"], ctx["load"])
    out["len"] = _vehscal(p["len"], ctx["len"])
    out["sum_dist"] = ctx["sum_dist"] + p["d_dist"]
    out["sum_late"] = ctx["sum_late"] + p["d_late"]
    out["sum_overflow"] = ctx["sum_overflow"] + p["d_over"]

    # packed lookup rows: the route-wide slot rewrite first, then the
    # changed rows' own values
    dem_new = utils["cust_packed"][p["new_c"].long(), 0]
    lane2 = torch.where(hit_pos, pos_val, ctx["row_pack"][..., 2])
    pos_rows = torch.sum(torch.where(mrow, out["pos"][..., None], 0), dim=1,
                         dtype=_I32)
    rp_vals = torch.stack([p["new_v"], p["new_c"], pos_rows, dem_new],
                          dim=-1)                             # [I, KD, 4]
    rp_new = torch.sum(torch.where(mrow[..., None], rp_vals[:, None], 0),
                       dim=2, dtype=_I32)
    row_pack = torch.cat([ctx["row_pack"][..., :2], lane2[..., None],
                          ctx["row_pack"][..., 3:]], dim=-1)
    out["row_pack"] = torch.where(hit_row[..., None], rp_new, row_pack)

    lane_vals = {2: p["len"].to(_I32), 3: _pack32(p["dist"]),
                 4: _pack32(p["late"]), 5: p["load"].to(_I32)}
    vp_cols = []
    for j in range(ctx["veh_pack"].shape[-1]):
        if j in lane_vals:
            nv = torch.sum(torch.where(mveh, lane_vals[j][:, None, :], 0),
                           dim=-1, dtype=_I32)
            vp_cols.append(torch.where(hit_veh, nv, ctx["veh_pack"][..., j]))
        else:
            vp_cols.append(ctx["veh_pack"][..., j])
    out["veh_pack"] = torch.stack(vp_cols, dim=-1)
    return out


# --- greedy init (host) -------------------------------------------------------

def greedy_init(dm, demands, capacities, depot_ids, n_depots):
    """Capacity-aware nearest-neighbour fill, vehicle by vehicle (the
    reference's host loop, `cotwin_builder.rs:153-255`), in numpy. Returns
    (vehicle_ids, customer_ids) int32 arrays of length n_stops + k; -1 rows
    mean "no greedy slot"."""
    dm = np.asarray(dm)
    demands = np.asarray(demands)
    capacities = np.asarray(capacities)
    depot_ids = np.asarray(depot_ids)
    l = dm.shape[0]
    k = capacities.shape[0]
    n_stops = l - n_depots
    steps = n_stops + k

    remaining = np.zeros((l,), bool)
    remaining[n_depots:] = True
    veh = 0
    prev = int(depot_ids[0])
    load = 0
    veh_out = np.full((steps,), -1, np.int32)
    cust_out = np.full((steps,), -1, np.int32)
    for i in range(steps):
        if veh >= k or not remaining.any():
            break
        d = np.where(remaining, dm[prev], np.inf)
        cand = int(np.argmin(d))
        cand_demand = int(demands[cand])
        if load + cand_demand <= capacities[veh]:
            remaining[cand] = False
            veh_out[i] = veh
            cust_out[i] = cand
            prev = cand
            load += cand_demand
        else:
            veh += 1
            prev = int(depot_ids[min(veh, k - 1)])
            load = 0
    return veh_out, cust_out


class CotwinBuilder(CotwinBuilderBase):
    """Builds the VRP cotwin; its tensors live on the device of the
    domain's distance matrix."""

    def __init__(self, use_incremental_score_calculation=True,
                 use_greed_init=True, exact_fp_scores=False):
        self.use_incremental_score_calculation = use_incremental_score_calculation
        self.use_greed_init = use_greed_init
        self.exact_fp_scores = exact_fp_scores

    def _initial_ids(self, domain, is_already_initialized):
        n_depots = len(domain.depot_vec)
        n_locations = len(domain.customers_vec)
        n_stops = n_locations - n_depots
        initial_vehicle = [None] * n_stops
        initial_customer = [None] * n_stops
        frozen = [False] * n_stops

        if is_already_initialized:
            i = 0
            for kk, vehicle in enumerate(domain.vehicles):
                for customer in vehicle.customers:
                    initial_vehicle[i] = kk
                    initial_customer[i] = customer.vec_id
                    frozen[i] = customer.frozen
                    i += 1
        elif self.use_greed_init:
            demands = np.array([c.demand for c in domain.customers_vec],
                               np.int64)
            capacities = np.array([v.capacity for v in domain.vehicles],
                                  np.int64)
            depot_ids = np.array([v.depot_vec_id for v in domain.vehicles],
                                 np.int32)
            # the host matrix rebuilt from coordinates, as the JAX package
            # does, so both packages start from the same greedy solution
            xs = np.array([c.latitude for c in domain.customers_vec])
            ys = np.array([c.longitude for c in domain.customers_vec])
            d = np.sqrt((xs[:, None] - xs[None, :]) ** 2
                        + (ys[:, None] - ys[None, :]) ** 2)
            fl = np.floor(d)
            dm_host = fl + np.floor((d - fl) * 1000.0) / 1000.0
            veh, cust = greedy_init(dm_host, demands,
                                    capacities, depot_ids, n_depots)
            valid = veh >= 0
            veh, cust = veh[valid].tolist(), cust[valid].tolist()
            for i in range(min(len(veh), n_stops)):
                initial_vehicle[i] = veh[i]
                initial_customer[i] = cust[i]
        return initial_vehicle, initial_customer, frozen

    def build_cotwin(self, domain, is_already_initialized):
        device = domain.distance_matrix.device
        n_depots = len(domain.depot_vec)
        n_locations = len(domain.customers_vec)
        n_stops = n_locations - n_depots
        k = len(domain.vehicles)

        init_v, init_c, frozen = self._initial_ids(domain, is_already_initialized)

        stops = []
        for i in range(n_stops):
            stops.append(CotStop(
                vehicle_id=GJInteger(init_v[i], 0, k - 1, frozen[i],
                                     ["vehicle_assignment", "common"]),
                customer_id=GJInteger(init_c[i], n_depots, n_locations - 1,
                                      frozen[i],
                                      ["customer_assignment", "common"]),
            ))

        fact_customers = [
            CotCustomer(c.vec_id, c.demand, c.time_window_start,
                        c.time_window_end, c.service_time)
            for c in domain.customers_vec[n_depots:]
        ]
        fact_vehicles = [
            CotVehicle(i, v.capacity, v.depot_vec_id, v.work_day_start,
                       v.work_day_end)
            for i, v in enumerate(domain.vehicles)
        ]

        cotwin = Cotwin()
        cotwin.add_problem_facts("vehicles", fact_vehicles)
        cotwin.add_problem_facts("customers", fact_customers)
        cotwin.add_planning_entities("planning_stops", stops)

        calc_cls = (
            IncrementalScoreCalculator
            if self.use_incremental_score_calculation
            else PlainScoreCalculator
        )
        calculator = calc_cls(HardMediumSoftScore, device)
        cust = domain.customers_vec
        vehs = domain.vehicles

        def i32(values):
            return torch.as_tensor(np.array(values, np.int32), device=device)

        add = calculator.add_utility_object
        add("distance_matrix", domain.distance_matrix)
        dm_milli = routes.distance_matrix_to_milli(domain.distance_matrix)
        add("distance_matrix_milli", dm_milli)
        add("dm_flat_milli", dm_milli.reshape(-1))
        add("exact_fp_scores", self.exact_fp_scores)
        # packed per-location fact rows [L, 4]: demand, tw_start, tw_end,
        # service
        add("cust_packed", i32([[c.demand, c.time_window_start,
                                 c.time_window_end, c.service_time]
                                for c in cust]))
        add("work_day_start_k", i32([v.work_day_start for v in vehs]))
        add("work_day_end_k", i32([v.work_day_end for v in vehs]))
        add("n_locations", n_locations)
        add("k_vehicles", k)
        add("time_windowed", domain.time_windowed)
        add("demand_by_vec_id", i32([c.demand for c in cust]))
        add("capacities", i32([v.capacity for v in vehs]))
        add("vehicle_depot_ids", i32([v.depot_vec_id for v in vehs]))

        route_cap = _route_cap(n_stops, k)
        add("route_cap", route_cap)
        add("n_stops", n_stops)
        # static accumulation dtype for per-route metrics: i32 whenever the
        # host-side instance bounds leave 4x headroom against overflow
        xs = [c.latitude for c in cust]
        ys = [c.longitude for c in cust]
        dm_max_milli = int(1000.0 * (
            (max(xs) - min(xs)) ** 2 + (max(ys) - min(ys)) ** 2) ** 0.5) + 1
        dist_bound = (route_cap + 2) * dm_max_milli
        late_bound = 0
        t_max = 0
        if domain.time_windowed:
            ct_max = max(c.service_time for c in cust)
            floor_max = max(c.time_window_start + c.service_time
                            for c in cust)
            w_max = max(v.work_day_start for v in vehs)
            t_max = max(w_max, floor_max) + (route_cap + 1) * ct_max
            late_bound = (route_cap + 1) * t_max
        acc_i32 = 4 * max(dist_bound, late_bound) < 2 ** 31
        add("acc_dtype", torch.int32 if acc_i32 else torch.int64)
        add("dm_max_milli", dm_max_milli)
        add("t_max", t_max)
        calculator.add_prescoring_function("build_common", build_common)
        calculator.add_constraint("no_duplicating_stops_constraint",
                                  no_duplicating_stops_constraint)
        calculator.add_constraint("capacity_constraint", capacity_constraint)
        calculator.add_constraint("minimize_distance", minimize_distance)
        calculator.add_constraint("late_arrival_penalty", late_arrival_penalty)
        if not domain.time_windowed:
            calculator.remove_constraint("late_arrival_penalty")
        # the delta kernels sum integer-milli distances; the exact scores
        # are plain only, as in the JAX package
        if self.use_incremental_score_calculation and not self.exact_fp_scores:
            from greyjack_tpu_torch.models.vrp import delta_kernel, sweep
            calculator.set_delta_kernels(build_delta_ctx, score_delta,
                                         update_ctx, ctx_score=ctx_score_row,
                                         ctx_ints=ctx_int_totals,
                                         int_scales=[1.0, 1.0, 1000.0])
            calculator.set_delta_batch_kernel(
                delta_kernel.score_delta_batch,
                delta_kernel.score_delta_batch_ints,
                eligible=delta_kernel.eligible_width)
            calculator.set_sweep_module(sweep)
        cotwin.add_score_calculator(calculator)
        return cotwin
