"""The int-delta path (`ScoreRequester.request_score_delta_ints`, the fused
kernel): the i32 delta rows of a sample of the neighbours and of the
winner, each rebuilt from its move and rescored from scratch. A stub row
is right only where the move overfills the port's route buffers."""

import torch

from gjbench import check
from gjbench.reference import common


def observe(capture):
    from greyjack_tpu_torch.score_calculation.score_requesters import (
        ScoreRequester)
    capture.watch(ScoreRequester, "request_score_delta_ints", "ints",
                  args=True)


def reduce(capture, seen, n_isl):
    if "ints" not in seen:
        return {}
    (_, _, deltas), ints = seen["ints"]
    return check.sample_rows(capture, deltas, ints, n_isl)


def judge(j):
    family, data = j.family, j.data
    cand_bad = winner_bad = 0
    for i in range(j.n_isl):
        rep_i = j.island(i)
        base_ints = family.ints(rep_i)
        cand = {k: v[i].to(j.device) for k, v in data["cand"].items()}
        moved = family.rep(check.apply_delta(
            j.base[i:i + 1].expand(cand["positions"].shape[0], -1), cand))
        ref = (family.ints(moved) - base_ints).cpu()
        rows = data["rows"][i]
        stub = rows[:, 0] == common.STUB
        got = torch.where(stub[:, None], rows, j.program(
            rows, lambda f: f.ints(moved) - f.ints(rep_i))).long()
        cand_bad += int(torch.sum(torch.any(got != ref, dim=1) & ~stub))
        cand_bad += int(torch.sum(
            stub & ~family.overfills(moved, j.width).cpu()))

        wd = {k: v[i:i + 1].to(j.device) for k, v in data["win_cand"].items()}
        win = family.rep(check.apply_delta(j.base[i:i + 1], wd))
        if int(data["win_row"][i, 0]) == common.STUB:
            winner_bad += int(not family.overfills(win, j.width).any())
            kept = False
        else:
            got_w = j.program(data["win_row"][i:i + 1],
                              lambda f: f.ints(win) - f.ints(rep_i))
            ref_w = (family.ints(win) - base_ints).cpu()
            winner_bad += int(not torch.equal(got_w.long(), ref_w))
            kept = j.kept(i, win)
        winner_bad += j.post_differs(i, win if kept else rep_i)
    return cand_bad, winner_bad
