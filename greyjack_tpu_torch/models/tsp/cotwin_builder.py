"""TSP cotwin + score functions (counterpart of
`greyjack_tpu/models/tsp/cotwin_builder.py`; reference
`examples/tsp/src/persistence/cotwin_builder.rs`, one GJInteger location id
per stop with bounds 1..L-1 and a greedy nearest-neighbour start, and
`score/plain_score_calculator.rs:26-87`): hard = duplicate stops, soft =
tour distance.

Shapes: the plain path scores a population (leading axis P); the delta path
keeps one ctx per island (leading axis I) and scores deltas [I, M, K] (M
neighbours per island) against it, applying one accepted delta [I, K] per
island in `update_ctx`. Every integer result and every f64 row is bit-equal
to the JAX package's.
"""

from __future__ import annotations

import numpy as np
import torch

from greyjack_tpu_torch.cotwin import Cotwin, CotwinBuilderBase
from greyjack_tpu_torch.variables import GJInteger
from greyjack_tpu_torch.score_calculation.scores import HardSoftScore
from greyjack_tpu_torch.score_calculation.score_calculators import (
    PlainScoreCalculator,
    IncrementalScoreCalculator,
)
from greyjack_tpu_torch.ops import segments, routes, moves
from greyjack_tpu_torch.utils.math_utils import true_div

_I32 = torch.int32
_I64 = torch.int64


class CotStop:
    def __init__(self, stop_id, locations_vec_id):
        self.stop_id = stop_id
        self.locations_vec_id = locations_vec_id

    def to_vec(self):
        return [
            ("stop_id", self.stop_id),
            ("locations_vec_id", self.locations_vec_id),
        ]


def greedy_tour(dm):
    """Nearest-neighbour tour from the depot (location 0) on the host, as
    the reference computes it once off the hot path
    (`cotwin_builder.rs:139-168`). Returns int32[L-1] location ids."""
    dm = np.asarray(dm)
    l = dm.shape[0]
    visited = np.zeros((l,), bool)
    visited[0] = True
    tour = np.empty((l - 1,), np.int32)
    prev = 0
    for i in range(l - 1):
        d = np.where(visited, np.inf, dm[prev])
        nxt = int(np.argmin(d))
        visited[nxt] = True
        tour[i] = nxt
        prev = nxt
    return tour


def _take(x, idx):
    """Per-island gather along axis 1: x [I, N], idx int[I, ...] ->
    [I, ...]."""
    return torch.gather(x, 1, idx.reshape(idx.shape[0], -1).long()).reshape(
        idx.shape)


# --- constraints ------------------------------------------------------------

def no_duplicating_stops_constraint(planning, facts, utils):
    stops = planning["path_stops"]["locations_vec_id"]
    hard = segments.count_minus_n_unique(stops, utils["n_locations"])
    return (hard, 0.0)


def minimize_distance(planning, facts, utils):
    stops = planning["path_stops"]["locations_vec_id"]
    if utils["exact_fp_scores"]:
        soft = routes.tour_distance(stops, utils["distance_matrix"], depot=0)
    else:
        soft = routes.tour_distance_fast(stops, utils["distance_matrix_milli"],
                                         depot=0, dm_at=utils.get("dm_at"),
                                         n_locations=utils["n_locations"])
    return (0.0, soft)


# --- delta (incremental) kernels ---------------------------------------------

def build_delta_ctx(planning, facts, utils):
    """O(N) base pass per island (planning stops [I, N]): tour values, value
    histogram, per-leg distances in integer milli (legs[i] joins position
    i-1 -> i; positions -1 and N are the depot) and the base score's exact
    sums."""
    s = planning["path_stops"]["locations_vec_id"].to(_I32)
    ni, n = s.shape
    l = utils["n_locations"]
    dmf = utils["dm_flat_milli"]
    counts = torch.zeros((ni, l), dtype=_I32, device=s.device).scatter_add_(
        1, s.long(), torch.ones_like(s))
    zero = torch.zeros((ni, 1), dtype=s.dtype, device=s.device)
    sl = torch.cat([zero, s], dim=1)
    sr = torch.cat([s, zero], dim=1)
    legs = dmf[(sl * l + sr).long()]                            # [I, N+1]
    soft_milli = torch.sum(legs, dim=1, dtype=_I64)
    hard = (n - torch.sum(counts > 0, dim=1)).to(_I32)
    return {"s": s, "counts": counts, "legs": legs,
            "hard": hard, "soft_milli": soft_milli}


def _delta_parts(ctx, delta, utils):
    """O(K) analysis of every delta (leaves [I, M, K]) against its island's
    ctx: changed rows, the affected legs (rows and rows+1, deduplicated
    after a sort), the exact n_unique and distance-milli deltas
    ([I, M] each)."""
    delta = moves.dedupe_delta(delta)
    l = utils["n_locations"]
    dmf = utils["dm_flat_milli"]
    s = ctx["s"]
    n = s.shape[1]
    rows = utils["delta_schema"]["var_row"][delta["positions"].long()]
    valid = delta["valid"]
    nv = torch.round(delta["values"]).to(_I32)
    old = _take(s, rows)

    d_unique = segments.nunique_delta(
        ctx["counts"], torch.where(valid, old, 0), torch.where(valid, nv, 0),
        valid)

    sent = n + 1
    legids = torch.cat([torch.where(valid, rows, sent),
                        torch.where(valid, rows + 1, sent)], dim=-1)
    sortedl = torch.sort(legids, dim=-1).values
    lfirst = torch.cat([torch.ones_like(sortedl[..., :1], dtype=torch.bool),
                        sortedl[..., 1:] != sortedl[..., :-1]], dim=-1)
    lvalid = lfirst & (sortedl <= n)
    old_leg = _take(ctx["legs"], torch.clamp(sortedl, max=n))

    def patched(j):
        # tour value at position j after the patch; the depot at j=-1 / j=n
        base_val = torch.where((j < 0) | (j >= n), 0,
                               _take(s, torch.clamp(j, 0, n - 1)))
        match = ((rows[..., None, :] == j[..., :, None])
                 & valid[..., None, :])                        # [.., 2K, K]
        first = torch.argmax(match.to(_I32), dim=-1)
        pick = torch.gather(nv, -1, first)
        return torch.where(torch.any(match, dim=-1), pick, base_val)

    u = patched(sortedl - 1)
    w = patched(sortedl)
    new_leg = dmf[torch.clamp(u * l + w, 0, l * l - 1).long()]
    d_soft = torch.sum(torch.where(lvalid, (new_leg - old_leg).to(_I64), 0),
                       dim=-1)
    return {"rows": rows, "valid": valid, "nv": nv, "old": old,
            "leg_ids": sortedl, "leg_valid": lvalid, "new_leg": new_leg,
            "d_unique": d_unique, "d_soft": d_soft}


def score_delta(ctx, deltas, utils):
    """f64[I, M, 2] score rows of every island's neighbours: the base
    histogram's exact n_unique delta and the distance delta over the <= 2K
    affected legs, equal to a full rescore of the patched tour bit for bit
    (integer-milli semantics)."""
    p = _delta_parts(ctx, deltas, utils)
    hard = (ctx["hard"][:, None] - p["d_unique"]).to(torch.float64)
    soft = true_div((ctx["soft_milli"][:, None] + p["d_soft"]).to(
        torch.float64), 1000.0)
    return torch.stack([hard, soft], dim=-1)


def ctx_score_row(ctx, utils):
    """f64[I, 2] score of each island's base candidate from its exact
    sums."""
    return torch.stack([ctx["hard"].to(torch.float64),
                        true_div(ctx["soft_milli"].to(torch.float64),
                                 1000.0)], dim=-1)


def ctx_int_totals(ctx, utils):
    """i64[I, 2] exact integer totals (hard count, distance milli); with
    int_scales [1, 1000] they map to `ctx_score_row` bit for bit, which
    keeps the sweep live under the reference's shipped
    `score_precision=[3,3]` (`examples/tsp/src/main.rs:56`)."""
    return torch.stack([ctx["hard"].to(_I64), ctx["soft_milli"].to(_I64)],
                       dim=-1)


def update_ctx(ctx, delta, utils):
    """Apply one accepted delta per island (leaves [I, K]) in O(K) scatters;
    a delta with no valid entry is the identity. Deduplicated positions
    give distinct rows, and the first of each equal sorted leg id is the
    only valid one, so no kept index is written twice."""
    p = _delta_parts(ctx, {k: x[:, None] for k, x in delta.items()}, utils)
    p = {k: x[:, 0] for k, x in p.items()}
    l = utils["n_locations"]
    n = ctx["s"].shape[1]
    valid = p["valid"]
    drop = segments.scatter_drop
    one = torch.ones_like(p["nv"])
    s2 = drop(ctx["s"], torch.where(valid, p["rows"], n), p["nv"])
    counts2 = drop(drop(ctx["counts"], torch.where(valid, p["old"], l), -one,
                        add=True),
                   torch.where(valid, p["nv"], l), one, add=True)
    legs2 = drop(ctx["legs"], torch.where(p["leg_valid"], p["leg_ids"], n + 1),
                 p["new_leg"])
    return {"s": s2, "counts": counts2, "legs": legs2,
            "hard": ctx["hard"] - p["d_unique"],
            "soft_milli": ctx["soft_milli"] + p["d_soft"]}


class CotwinBuilder(CotwinBuilderBase):
    def __init__(self, use_incremental_score_calculation=True,
                 use_greed_init=True, exact_fp_scores=False):
        self.use_incremental_score_calculation = use_incremental_score_calculation
        self.use_greed_init = use_greed_init
        self.exact_fp_scores = exact_fp_scores

    def build_cotwin(self, domain, is_already_initialized):
        device = domain.distance_matrix.device
        n_locations = len(domain.locations_vec)
        n_stops = n_locations - 1
        xs = np.array([lc.latitude for lc in domain.locations_vec])
        ys = np.array([lc.longitude for lc in domain.locations_vec])

        if is_already_initialized and domain.trip_path:
            initial_ids = [int(i) for i in domain.trip_path]
        elif self.use_greed_init:
            # the host matrix rebuilt from coordinates, as the JAX package
            # does, so both packages start from the same greedy tour
            dm_host = np.sqrt((xs[:, None] - xs[None, :]) ** 2
                              + (ys[:, None] - ys[None, :]) ** 2)
            initial_ids = greedy_tour(dm_host).tolist()
        else:
            initial_ids = [i + 1 for i in range(n_stops)]

        stops = [CotStop(stop_id=i,
                         locations_vec_id=GJInteger(initial_ids[i], 1,
                                                    n_locations - 1, False,
                                                    None))
                 for i in range(n_stops)]
        cotwin = Cotwin()
        cotwin.add_planning_entities("path_stops", stops)

        calc_cls = (
            IncrementalScoreCalculator
            if self.use_incremental_score_calculation
            else PlainScoreCalculator
        )
        calculator = calc_cls(HardSoftScore, device)
        add = calculator.add_utility_object
        add("distance_matrix", domain.distance_matrix)
        dm_milli = routes.distance_matrix_to_milli(domain.distance_matrix)
        add("distance_matrix_milli", dm_milli)
        add("dm_flat_milli", dm_milli.reshape(-1))
        add("exact_fp_scores", self.exact_fp_scores)
        add("n_locations", n_locations)
        # magnitude bound for the sweep's eligibility, computed on the host
        # from the coordinates (Python floats, as in the JAX package)
        lat = [lc.latitude for lc in domain.locations_vec]
        lon = [lc.longitude for lc in domain.locations_vec]
        add("dm_max_milli", int(1000.0 * (
            (max(lat) - min(lat)) ** 2 + (max(lon) - min(lon)) ** 2) ** 0.5)
            + 1)
        calculator.add_constraint("no_duplicating_stops_constraint",
                                  no_duplicating_stops_constraint)
        calculator.add_constraint("minimize_distance", minimize_distance)
        if self.use_incremental_score_calculation and not self.exact_fp_scores:
            from greyjack_tpu_torch.models.tsp import sweep
            calculator.set_delta_kernels(build_delta_ctx, score_delta,
                                         update_ctx, ctx_score=ctx_score_row,
                                         ctx_ints=ctx_int_totals,
                                         int_scales=[1.0, 1000.0])
            calculator.set_sweep_module(sweep)
        cotwin.add_score_calculator(calculator)
        return cotwin
