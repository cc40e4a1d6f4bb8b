"""The f64 delta path (`ScoreRequester.request_score_delta`: each
neighbour's exact integer sums against its island's ctx, divided once):
the score rows of a sample of the neighbours and of the winner, each
rebuilt from its move with `check.apply_delta` and rescored from scratch.
The rows are compared as the port returns them, before the score
precision's truncation; the step ranks them after it, so the winner is
the lexicographic minimum of the port's rows truncated by the reference's
own recipe (`common.round3`)."""

import torch

from gjbench import check
from gjbench.reference import common


def observe(capture):
    from greyjack_tpu_torch.score_calculation.score_requesters import (
        ScoreRequester)
    capture.watch(ScoreRequester, "request_score_delta", "rows", args=True)


def reduce(capture, seen, n_isl):
    if "rows" not in seen:
        return {}
    (_, _, deltas), rows = seen["rows"]
    out = check.sample_rows(capture, deltas, rows, n_isl)
    # every row and move, for the winner of the truncated rows
    out["all_rows"] = rows.cpu()
    out["all_cand"] = {k: v.cpu() for k, v in deltas.items()}
    return out


def _ranked(rows, precision):
    """The rows the step ranks: truncated where a precision is set."""
    if precision is None:
        return rows
    return torch.as_tensor(common.round3(rows.numpy()))


def judge(j):
    family, data = j.family, j.data
    cand_bad = winner_bad = 0
    wins = common.lex_argmin(_ranked(data["all_rows"], j.precision))
    for i in range(j.n_isl):
        rep_i = j.island(i)
        cand = {k: v[i].to(j.device) for k, v in data["cand"].items()}
        moved = family.rep(check.apply_delta(
            j.base[i:i + 1].expand(cand["positions"].shape[0], -1), cand))
        want = family.rows(moved).cpu()
        got = j.program(data["rows"][i], lambda f: f.rows(moved))
        cand_bad += int(torch.sum(torch.any(want != got, dim=1)))

        w = int(wins[i])
        wd = {k: v[i, w][None].to(j.device)
              for k, v in data["all_cand"].items()}
        win = family.rep(check.apply_delta(j.base[i:i + 1], wd))
        got_w = j.program(data["all_rows"][i, w][None],
                          lambda f: f.rows(win))
        winner_bad += int(not torch.equal(family.rows(win).cpu(), got_w))
        winner_bad += j.post_differs(i, win if j.kept(i, win) else rep_i)
    return cand_bad, winner_bad
