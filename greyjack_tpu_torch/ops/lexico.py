"""Lexicographic ops over score rows `[..., S]` (f64 score rows or integer
delta rows). Counterpart of `greyjack_tpu/ops/lexico.py`; every function
broadcasts over leading axes (islands, neighbours)."""

import sys

import torch


def lex_less(a, b):
    """Elementwise lexicographic a < b over the trailing score axis."""
    a, b = torch.broadcast_tensors(a, b)
    lt = a < b
    gt = a > b
    result = torch.zeros(a.shape[:-1], dtype=torch.bool, device=a.device)
    decided = torch.zeros_like(result)
    for i in range(a.shape[-1]):
        result = result | (~decided & lt[..., i])
        decided = decided | lt[..., i] | gt[..., i]
    return result


def lex_leq(a, b):
    return ~lex_less(b, a)


def lex_argmin(scores):
    """Index of the lexicographically smallest row along axis -2:
    scores [..., N, S] -> int64 [...]. Ties go to the lowest index
    (`Iterator::min_by`, `tabu_search_base.rs:166-171`): S masked column
    minima, then the first row still eligible."""
    if scores.dtype.is_floating_point:
        big = torch.tensor(float("inf"), dtype=scores.dtype,
                           device=scores.device)
    else:
        big = torch.tensor(torch.iinfo(scores.dtype).max, dtype=scores.dtype,
                           device=scores.device)
    eligible = torch.ones(scores.shape[:-1], dtype=torch.bool,
                          device=scores.device)
    for i in range(scores.shape[-1]):
        col = scores[..., i]
        m = torch.amin(torch.where(eligible, col, big), dim=-1, keepdim=True)
        eligible = eligible & (col == m)
    # argmax over int32 returns the first maximal index
    return torch.argmax(eligible.to(torch.int32), dim=-1)


def lex_sort_order(scores):
    """int64[..., N]: the stable ascending lexicographic order of the rows
    of `scores` [..., N, S] (`greyjack_tpu/ops/lexico.py:60-69`). torch has
    no multi-key sort, so stable sorts are chained from the last key to
    the first."""
    n = scores.shape[-2]
    order = torch.arange(n, device=scores.device).expand(
        scores.shape[:-1]).contiguous()
    for i in reversed(range(scores.shape[-1])):
        key = torch.gather(scores[..., i], -1, order)
        idx = torch.sort(key, dim=-1, stable=True).indices
        order = torch.gather(order, -1, idx)
    return order


def take_rows(x, idx):
    """x[..., N, *rest] -> x[..., idx, *rest] for idx int[..., M]: rows
    gathered along the axis after idx's leading axes."""
    d = idx.dim() - 1
    rest = x.shape[d + 1:]
    full = idx.reshape(idx.shape + (1,) * len(rest)).expand(
        idx.shape + rest)
    return torch.gather(x, d, full.long())


def lex_sort_scores_with(scores, *payloads):
    """Sort the rows of `scores` [..., N, S] lexicographically ascending,
    carrying payloads with the same leading [..., N] axes. Returns
    (sorted_scores, *sorted_payloads)."""
    order = lex_sort_order(scores)
    return (take_rows(scores, order),) + tuple(take_rows(p, order)
                                                for p in payloads)


def stub_score_row(s, dtype=torch.float64, device=None):
    """The reference's f64::MAX-1 sentinel (`simple_score.rs:60-64`)."""
    return torch.full((s,), sys.float_info.max - 1.0, dtype=dtype,
                      device=device)
