"""Route walks for VRP scoring (counterpart of `greyjack_tpu/ops/routes.py`).

Every function works on the last axis and broadcasts over leading axes (the
population batch), so one call scores a whole population. Distances are
exact integer-milli sums (order-free), lateness is integer max-plus
arithmetic, so the rows are bit-equal to the JAX package's.
"""

import torch


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


def _maxplus_scan(adds, floors):
    """Inclusive prefix composition of max-plus maps f(x) = max(x + a, u)
    along the last axis (Hillis-Steele doubling, i32). The -2^30 "minus
    infinity" is re-clamped each round so repeated reset maps cannot
    underflow."""
    neg = -(1 << 30)
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
                      work_day_end, cust_rows, time_windowed, precision=3):
    """Scatter-free route walk over stops sorted by vehicle.

    sorted ids: i32[..., N]; cust_rows: i32[..., N, 4] per sorted stop
    ([demand, tw_start, tw_end, service]). Returns (sum_distance,
    sum_time_penalty), f64[...] each."""
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
    vals3 = dm_flat_milli[idx3.long()]
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
    sum_distance = total_milli.to(torch.float64) / float(10 ** precision)

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
