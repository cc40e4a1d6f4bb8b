"""The plain path (`PlainMoveStep.propose`, a full rescore of every
neighbour): the score rows of a sample of the neighbours and of the
winner, rescored from scratch."""

import torch

from gjbench import check


def observe(capture):
    from greyjack_tpu_torch.agents.base import PlainMoveStep
    capture.watch(PlainMoveStep, "propose", "plain")


def reduce(capture, seen, n_isl):
    if "plain" not in seen:
        return {}
    moved, _, scores = seen["plain"]
    return check.sample_rows(capture, {"rows": moved}, scores, n_isl)


def judge(j):
    family, data, precision = j.family, j.data, j.precision
    cand_bad = winner_bad = 0
    for i in range(j.n_isl):
        cands = family.rep(data["cand"]["rows"][i].to(j.device).long())
        want = family.rows(cands, precision).cpu()
        got = j.program(data["rows"][i], lambda f: f.rows(cands, precision))
        cand_bad += int(torch.sum(torch.any(want != got, dim=1)))
        win = family.rep(data["win_cand"]["rows"][i:i + 1].to(j.device)
                         .long())
        want_w = family.rows(win, precision).cpu()
        got_w = j.program(data["win_row"][i:i + 1],
                          lambda f: f.rows(win, precision))
        winner_bad += int(not torch.equal(want_w, got_w))
        winner_bad += j.post_differs(i, win if j.kept(i, win)
                                     else j.island(i))
    return cand_bad, winner_bad
