"""Tour and route walks for TSP / VRP scoring (counterpart of
`greyjack_tpu/ops/routes.py`).

Every function works on the last axis and broadcasts over leading axes (the
population batch), so one call scores a whole population. The fast walks'
distances are exact integer-milli sums (order-free) and their lateness is
integer max-plus arithmetic; the exact walks (`tour_distance`,
`vrp_routes`) fold the f64 distances in the reference's sequential order.
All give rows bit-equal to the JAX package's.
"""

import torch

from greyjack_tpu_torch.utils.math_utils import true_div


def sort_stops_by_vehicle(vehicle_ids):
    """Stable sort of stop positions by vehicle id along the last axis.
    Returns (sorted_vehicle_ids, perm) with perm[..., i] = original position
    (int64). Stability keeps the stops of a vehicle in stop-index order."""
    sorted_v, perm = torch.sort(vehicle_ids, dim=-1, stable=True)
    return sorted_v, perm


def distance_matrix_to_milli(distance_matrix, precision=3):
    """Distance matrix as exact scaled integers i32 (the matrix is truncated
    to `precision` decimals, so `d * 10^p` rounds to an exact integer;
    `torch.round` rounds half to even like `jnp.round`)."""
    scale = float(10 ** precision)
    return torch.round(distance_matrix * scale).to(torch.int32)


def _maxplus_scan(adds, floors, neg=-(1 << 30)):
    """Inclusive prefix composition of max-plus maps f(x) = max(x + a, u)
    along the last axis (Hillis-Steele doubling; i32 with the default
    "minus infinity" `neg`, i64 with -2^62). `neg` is re-clamped each
    round so repeated reset maps cannot underflow."""
    a, u = adds, floors
    n = a.shape[-1]
    d = 1
    while d < n:
        la = torch.cat([torch.zeros_like(a[..., :d]), a[..., :-d]], dim=-1)
        lu = torch.cat([torch.full_like(u[..., :d], neg), u[..., :-d]],
                       dim=-1)
        a, u = torch.clamp(la + a, min=neg), torch.maximum(lu + a, u)
        d *= 2
    return torch.maximum(a, u)


def vrp_routes_packed(sorted_vehicle_ids, sorted_customer_ids, dm_flat_milli,
                      n_locations, vehicle_depot_ids, work_day_start,
                      work_day_end, cust_rows, time_windowed, precision=3,
                      dm_at=None):
    """Scatter-free route walk over stops sorted by vehicle.

    sorted ids: i32[..., N]; cust_rows: i32[..., N, 4] per sorted stop
    ([demand, tw_start, tw_end, service]). Returns (sum_distance,
    sum_time_penalty), f64[...] each. `dm_at` (optional): a flat-index
    accessor used instead of indexing `dm_flat_milli` (the partitioned
    facts' owner-computes gather, `ops/partitioned.py`); integer sums make
    the result the same either way."""
    v = sorted_vehicle_ids.long()
    s = sorted_customer_ids
    l = n_locations
    n = s.shape[-1]
    lead = s.shape[:-1]
    one = torch.ones(lead + (1,), dtype=torch.bool, device=s.device)

    is_first = torch.cat([one, v[..., 1:] != v[..., :-1]], dim=-1)
    is_last = torch.cat([v[..., :-1] != v[..., 1:], one], dim=-1)

    depot_of_stop = vehicle_depot_ids[v].to(s.dtype)
    idx3 = torch.cat([
        s[..., :-1] * l + s[..., 1:],           # chain legs      [N-1]
        depot_of_stop * l + s,                  # depot->first    [N]
        s * l + depot_of_stop,                  # last->depot     [N]
    ], dim=-1)
    vals3 = (dm_flat_milli[idx3.long()] if dm_at is None
             else dm_at(idx3))
    chain_vals = vals3[..., :n - 1]
    start_vals = vals3[..., n - 1:2 * n - 1]
    return_vals = vals3[..., 2 * n - 1:]
    chain_leg = torch.cat(
        [torch.zeros(lead + (1,), dtype=chain_vals.dtype, device=s.device),
         torch.where(is_first[..., 1:], 0, chain_vals)], dim=-1)
    start_leg = torch.where(is_first, start_vals, 0)
    return_leg = torch.where(is_last, return_vals, 0)
    total_milli = (torch.sum(chain_leg, dim=-1, dtype=torch.int64)
                   + torch.sum(start_leg + return_leg, dim=-1,
                               dtype=torch.int64))
    sum_distance = true_div(total_milli.to(torch.float64),
                            float(10 ** precision))

    if not time_windowed:
        return sum_distance, torch.zeros_like(sum_distance)

    big = 1 << 30
    cs = cust_rows[..., 1]
    ce = cust_rows[..., 2]
    ct = cust_rows[..., 3]
    w0_at = torch.where(is_first, work_day_start[v].to(torch.int32), 0)
    w1_at = torch.where(is_last, work_day_end[v].to(torch.int32), 0)

    adds = torch.where(is_first, -big, ct).to(torch.int32)
    floors = torch.where(is_first, torch.maximum(w0_at, cs) + ct, cs + ct)
    post = _maxplus_scan(adds, floors)

    late = torch.clamp(post - ce, min=0)
    overtime = torch.where(is_last, torch.clamp(post - w1_at, min=0), 0)
    sum_time_penalty = torch.sum(late + overtime, dim=-1,
                                 dtype=torch.int64).to(torch.float64)
    return sum_distance, sum_time_penalty


def _seq_sum(values):
    """Left-to-right sequential f64 fold from 0.0 over the last axis (Rust's
    `fold(0.0, +)`): one add per position, the leading axes in parallel."""
    total = torch.zeros(values.shape[:-1], dtype=values.dtype,
                        device=values.device)
    for j in range(values.shape[-1]):
        total = total + values[..., j]
    return total


def tour_distance(stops, distance_matrix, depot=0):
    """Closed-tour distance in the reference's f64 summation order
    (tsp `plain_score_calculator.rs:73-76`):
    (dm[depot, s0] + dm[s_last, depot]) + fold(0.0, chain legs).

    stops: int[..., N] location ids; distance_matrix: f64[L, L]. Returns
    f64[...]. The fold is `_seq_sum`, one add per chain leg."""
    s = stops.long()
    dm = distance_matrix
    legs = dm[s[..., :-1], s[..., 1:]]
    ends = dm[depot, s[..., 0]] + dm[s[..., -1], depot]
    return ends + _seq_sum(legs)


def tour_distance_fast(stops, dm_milli, depot=0, precision=3, dm_at=None,
                       n_locations=None):
    """Order-free closed-tour distance over the exact integer-milli matrix:
    the legs summed in i64, divided once (`true_div`). Returns f64[...].

    `dm_at` (optional): a flat-index accessor `int[...] -> i32[...]` used
    instead of indexing `dm_milli` (the JAX package's partitioned-facts
    mode passes one); it needs `n_locations`. Integer sums make the result
    the same either way."""
    s = stops.long()
    if dm_at is None:
        legs = dm_milli[s[..., :-1], s[..., 1:]]
        ends = dm_milli[depot, s[..., 0]] + dm_milli[s[..., -1], depot]
    else:
        l = n_locations
        legs = dm_at(s[..., :-1] * l + s[..., 1:])
        ends = dm_at(depot * l + s[..., 0]) + dm_at(s[..., -1] * l + depot)
    total = torch.sum(legs, dim=-1, dtype=torch.int64) + ends
    return true_div(total.to(torch.float64), float(10 ** precision))


def vrp_routes(sorted_vehicle_ids, sorted_customer_ids, distance_matrix,
               vehicle_depot_ids, num_vehicles, work_day_start=None,
               work_day_end=None, cust_rows=None):
    """Distance and time-window lateness of all routes, in the reference's
    f64 summation order (`greyjack_tpu/ops/routes.py` `vrp_routes`): each
    route's distance is (depot leg + return leg) + the left fold from 0.0
    of its chain legs, and the routes fold from 0.0 in ascending vehicle
    id; empty vehicles add 0.0.

    Inputs along the last axis, stops stably sorted by vehicle
    (`sort_stops_by_vehicle`): ids int[..., N]; cust_rows i32[..., N, 4]
    ([demand, tw_start, tw_end, service]) per sorted stop for the
    lateness, None without time windows. Returns (sum_distance,
    sum_time_penalty), f64[...] each.

    The chain fold loops over the slots of the longest route with every
    (row, vehicle) pair as the tensor axes, so each route's legs add in
    stop order whatever the device; a parallel cumsum would not keep that
    order. The lateness is exact i64 max-plus arithmetic."""
    v = sorted_vehicle_ids.long()
    s = sorted_customer_ids.long()
    dm = distance_matrix
    l = dm.shape[-1]
    dmf = dm.reshape(-1)
    dev = s.device
    lead = s.shape[:-1]
    n = s.shape[-1]
    kk = torch.arange(num_vehicles, device=dev).expand(lead + (num_vehicles,))
    start = torch.searchsorted(v.contiguous(), kk.contiguous())  # [..., K]
    end = torch.searchsorted(v.contiguous(), kk.contiguous(), right=True)
    length = end - start
    has_stops = length > 0
    first = torch.gather(s, -1, torch.clamp(start, max=n - 1))
    last = torch.gather(s, -1, torch.clamp(end - 1, min=0))
    depots = vehicle_depot_ids.long()[kk]

    # chain legs per sorted stop: the leg from the previous stop (0 at a
    # route's first stop, masked below)
    legs = torch.cat([torch.zeros(lead + (1,), dtype=dm.dtype, device=dev),
                      dmf[s[..., :-1] * l + s[..., 1:]]], dim=-1)
    chain = torch.zeros(lead + (num_vehicles,), dtype=dm.dtype, device=dev)
    r_max = int(length.max()) if length.numel() else 0
    for j in range(1, r_max):
        at = start + j
        leg = torch.gather(legs, -1, torch.clamp(at, max=n - 1))
        chain = torch.where(j < length, chain + leg, chain)
    ends = dmf[depots * l + first] + dmf[last * l + depots]
    vehicle_dist = torch.where(has_stops, ends + chain, 0.0)
    sum_distance = _seq_sum(vehicle_dist)

    if cust_rows is None:
        return sum_distance, torch.zeros_like(sum_distance)
    is_first = torch.cat([torch.ones(lead + (1,), dtype=torch.bool,
                                     device=dev),
                          v[..., 1:] != v[..., :-1]], dim=-1)
    is_last = torch.cat([v[..., :-1] != v[..., 1:],
                         torch.ones(lead + (1,), dtype=torch.bool,
                                    device=dev)], dim=-1)
    i64 = torch.int64
    cs = cust_rows[..., 1].to(i64)
    ce = cust_rows[..., 2].to(i64)
    ct = cust_rows[..., 3].to(i64)
    w0 = work_day_start.long()[v]
    w1 = work_day_end.long()[v]
    # arrival after service: a = max(a, tw_start) + service, reset to the
    # work-day start at each route's first stop, as a max-plus prefix scan
    adds = torch.where(is_first, -(1 << 62), ct)
    floors = torch.where(is_first, torch.maximum(w0, cs) + ct, cs + ct)
    post = _maxplus_scan(adds, floors, neg=-(1 << 62))
    late = torch.clamp(post - ce, min=0)
    overtime = torch.where(is_last, torch.clamp(post - w1, min=0), 0)
    sum_time_penalty = torch.sum(late + overtime, dim=-1).to(torch.float64)
    return sum_distance, sum_time_penalty


def vrp_routes_fast(sorted_vehicle_ids, sorted_customer_ids, dm_milli,
                    vehicle_depot_ids, num_vehicles, precision=3,
                    work_day_start=None, work_day_end=None, tw_start=None,
                    tw_end=None, service_time=None):
    """Distance and time-window lateness of all routes with no sequential
    loop, over stops stably sorted by vehicle (`sort_stops_by_vehicle`):
    ids int[..., N]; per-vehicle `work_day_*` and per-location `tw_*` /
    `service_time` int tables. Returns (sum_distance, sum_time_penalty),
    f64[...] each.

    Distance: exact integer-milli sums (equal to the sequential f64 fold
    after the `score_precision` round). Lateness: the arrival recurrence
    `a = max(a, tw_start) + service` as a max-plus prefix scan in i32, each
    route's first stop resetting it to its work-day start; the penalty sum
    widens to i64. `num_vehicles` is kept for API compatibility."""
    v = sorted_vehicle_ids.long()
    s = sorted_customer_ids.long()
    lead = s.shape[:-1]
    one = torch.ones(lead + (1,), dtype=torch.bool, device=s.device)
    is_first = torch.cat([one, v[..., 1:] != v[..., :-1]], dim=-1)
    is_last = torch.cat([v[..., :-1] != v[..., 1:], one], dim=-1)

    depot_of_stop = vehicle_depot_ids.long()[v]
    start_leg = torch.where(is_first, dm_milli[depot_of_stop, s], 0)
    return_leg = torch.where(is_last, dm_milli[s, depot_of_stop], 0)
    chain_leg = torch.cat(
        [torch.zeros(lead + (1,), dtype=dm_milli.dtype, device=s.device),
         torch.where(is_first[..., 1:], 0,
                     dm_milli[s[..., :-1], s[..., 1:]])], dim=-1)
    i64 = torch.int64
    total_milli = torch.sum(start_leg.to(i64) + return_leg.to(i64)
                            + chain_leg.to(i64), dim=-1)
    sum_distance = true_div(total_milli.to(torch.float64),
                            float(10 ** precision))
    if tw_start is None:
        return sum_distance, torch.zeros_like(sum_distance)

    i32 = torch.int32
    cs = tw_start[s].to(i32)
    ce = tw_end[s].to(i32)
    ct = service_time[s].to(i32)
    w0 = work_day_start[v].to(i32)
    w1 = work_day_end[v].to(i32)
    adds = torch.where(is_first, -(1 << 30), ct).to(i32)
    floors = torch.where(is_first, torch.maximum(w0, cs) + ct, cs + ct)
    post = _maxplus_scan(adds, floors)
    late = torch.clamp(post - ce, min=0)
    overtime = torch.where(is_last, torch.clamp(post - w1, min=0), 0)
    sum_time_penalty = torch.sum((late + overtime).to(i64),
                                 dim=-1).to(torch.float64)
    return sum_distance, sum_time_penalty
