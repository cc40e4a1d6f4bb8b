"""N-Queens cotwin + score functions (counterpart of
`greyjack_tpu/models/nqueens/cotwin_builder.py`; reference
`examples/nqueens/src/persistence/cotwin_builder.rs:40-94`, one GJInteger
row per queen with bounds 0..n-1, and `score/plain_score_calculator.rs:
26-67`, the fused `all_different` constraint: (len - n_unique) over rows,
descending (col+row) and ascending (col-row) diagonals).

The delta path keeps the three families' histograms per island (ctx leaves
[I, ...]); every neighbour (delta leaves [I, M, K]) costs three exact
`nunique_delta`s. There is no f64 ctx score: the model registers only the
integer totals, as the JAX package does.
"""

from __future__ import annotations

import torch

from greyjack_tpu_torch.cotwin import Cotwin, CotwinBuilderBase
from greyjack_tpu_torch.variables import GJInteger
from greyjack_tpu_torch.score_calculation.scores import SimpleScore
from greyjack_tpu_torch.score_calculation.score_calculators import (
    PlainScoreCalculator,
    IncrementalScoreCalculator,
)
from greyjack_tpu_torch.ops import segments, moves

_I32 = torch.int32


class CotQueen:
    def __init__(self, queen_id, row_id, column_id):
        self.queen_id = queen_id
        self.row_id = row_id
        self.column_id = column_id

    def to_vec(self):
        return [
            ("queen_id", self.queen_id),
            ("row_id", self.row_id),
            ("column_id", self.column_id),
        ]


def all_different(planning, facts, utils):
    queens = planning["queens"]
    rows = queens["row_id"]
    cols = queens["column_id"]
    n = rows.shape[-1]
    row_conflicts = segments.count_minus_n_unique(rows, n)
    desc_conflicts = segments.count_minus_n_unique(cols + rows, 2 * n - 1)
    asc_conflicts = segments.count_minus_n_unique(cols - rows + (n - 1),
                                                  2 * n - 1)
    return (row_conflicts + desc_conflicts + asc_conflicts,)


# --- delta (incremental) kernels ---------------------------------------------

def _histogram(keys, width):
    return torch.zeros((keys.shape[0], width), dtype=_I32,
                       device=keys.device).scatter_add_(
        1, keys.long(), torch.ones_like(keys, dtype=_I32))


def build_delta_ctx(planning, facts, utils):
    """Per island (rows [I, N]): the row / descending / ascending diagonal
    histograms and the conflict total."""
    rows = planning["queens"]["row_id"].to(_I32)
    n = rows.shape[1]
    cols = torch.arange(n, dtype=rows.dtype, device=rows.device)
    counts_r = _histogram(rows, n)
    counts_d = _histogram(cols + rows, 2 * n - 1)
    counts_a = _histogram(cols - rows + (n - 1), 2 * n - 1)
    conflicts = (3 * n - torch.sum(counts_r > 0, dim=1)
                 - torch.sum(counts_d > 0, dim=1)
                 - torch.sum(counts_a > 0, dim=1)).to(_I32)
    return {"rows": rows, "counts_r": counts_r, "counts_d": counts_d,
            "counts_a": counts_a, "conflicts": conflicts}


def _parts(ctx, delta, utils):
    """Queen index, validity, new and old rows of every delta entry (leaves
    [I, M, K], deduplicated) and the exact conflict-count change
    (i32[I, M])."""
    delta = moves.dedupe_delta(delta)
    rows_arr = ctx["rows"]
    n = rows_arr.shape[1]
    q = utils["delta_schema"]["var_row"][delta["positions"].long()]
    valid = delta["valid"]
    nv = torch.round(delta["values"]).to(_I32)
    old = torch.gather(rows_arr, 1, q.reshape(q.shape[0], -1).long()
                       ).reshape(q.shape)

    def nud(counts, old_k, new_k):
        return segments.nunique_delta(counts, torch.where(valid, old_k, 0),
                                      torch.where(valid, new_k, 0), valid)

    d = (nud(ctx["counts_r"], old, nv)
         + nud(ctx["counts_d"], q + old, q + nv)
         + nud(ctx["counts_a"], q - old + (n - 1), q - nv + (n - 1)))
    return q, valid, nv, old, d


def score_delta(ctx, deltas, utils):
    """f64[I, M, 1] conflict counts of every island's neighbours."""
    _, _, _, _, d = _parts(ctx, deltas, utils)
    return (ctx["conflicts"][:, None] - d).to(torch.float64)[..., None]


def update_ctx(ctx, delta, utils):
    """Apply one accepted delta per island (leaves [I, K]); a delta with no
    valid entry is the identity. Dropped writes go to a sentinel column
    that is cut off; deduplicated positions never repeat a kept row."""
    q, valid, nv, old, d = _parts(
        ctx, {k: x[:, None] for k, x in delta.items()}, utils)
    q, valid, nv, old, d = q[:, 0], valid[:, 0], nv[:, 0], old[:, 0], d[:, 0]
    rows_arr = ctx["rows"]
    n = rows_arr.shape[1]
    one = torch.ones_like(nv)
    drop = segments.scatter_drop

    def upd(counts, old_k, new_k, sent):
        out = drop(counts, torch.where(valid, old_k, sent), -one, add=True)
        return drop(out, torch.where(valid, new_k, sent), one, add=True)

    rows2 = drop(rows_arr, torch.where(valid, q, n), nv)
    return {
        "rows": rows2,
        "counts_r": upd(ctx["counts_r"], old, nv, n),
        "counts_d": upd(ctx["counts_d"], q + old, q + nv, 2 * n - 1),
        "counts_a": upd(ctx["counts_a"], q - old + (n - 1),
                        q - nv + (n - 1), 2 * n - 1),
        "conflicts": ctx["conflicts"] - d,
    }


def ctx_int_totals(ctx, utils):
    """i64[I, 1] exact integer score totals (SimpleScore is integral): they
    keep the delta fast paths live under `score_precision`."""
    return ctx["conflicts"].to(torch.int64)[:, None]


class CotwinBuilder(CotwinBuilderBase):
    def __init__(self, use_incremental_score_calculation=True):
        self.use_incremental_score_calculation = use_incremental_score_calculation

    def build_cotwin(self, domain, is_already_initialized):
        n = domain.n
        cot_queens = [
            CotQueen(queen_id=i,
                     row_id=GJInteger(queen.row_id, 0, n - 1, False, None),
                     column_id=queen.column_id)
            for i, queen in enumerate(domain.queens)
        ]
        cotwin = Cotwin()
        cotwin.add_planning_entities("queens", cot_queens)

        calc_cls = (
            IncrementalScoreCalculator
            if self.use_incremental_score_calculation
            else PlainScoreCalculator
        )
        calculator = calc_cls(SimpleScore, domain.device)
        calculator.add_constraint("all_different", all_different)
        if self.use_incremental_score_calculation:
            calculator.set_delta_kernels(build_delta_ctx, score_delta,
                                         update_ctx, ctx_ints=ctx_int_totals,
                                         int_scales=[1.0])
        cotwin.add_score_calculator(calculator)
        return cotwin
