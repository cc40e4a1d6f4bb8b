"""The sweep path (`models/<family>/sweep.py` of the family's
`sweep_module`): every candidate of a sample of the drawn targets is
rescored from scratch, and the winner, the lexicographic minimum of the
port's keys over all targets, is rebuilt by the reference's own move
semantics: its key, its exact re-score, its delta row and whether the step
kept it.

Kept of the step: the keys, validity and convergence of every candidate of
`sample` targets an island; the winner's flat index, key and convergence;
the port's delta and exact rows of the winner; the tabu rows and target
validity the port used. A key part that a non-converged candidate only
bounds from below (the family's `bounded_parts`) may lie below the
rescore; every other part equals it.
"""

import importlib

import torch

from gjbench import check
from gjbench.reference import common


def observe(capture):
    mod = importlib.import_module(capture.family.sweep_module)
    capture.watch(mod, "score_candidates", "sc")
    capture.watch(mod, "propose_from_targets", "proposal", args=True)


def _keys(family, sc, f):
    return torch.stack([sc[f + "_" + p].long() for p in family.key_parts],
                       dim=-1)


def _conv(sc, f):
    return sc.get(f + "_conv", torch.ones_like(sc[f + "_valid"]))


def reduce(capture, seen, n_isl):
    if not {"sc", "proposal"} <= seen.keys():
        return {}
    family = capture.family
    sc = seen["sc"]
    (ctx, t_rows, t_valid, row_tabu, cfg, _), out = seen["proposal"]
    fams = family.sweep_families
    widths = [sc[f + "_hard"].shape[2] for f in fams]
    picks = check.sample(capture.rng, n_isl, t_rows.shape[1],
                         capture.count).to(t_rows.device)
    keys = torch.cat([
        torch.where(sc[f + "_valid"][..., None], _keys(family, sc, f),
                    common.STUB).reshape(n_isl, -1, len(family.key_parts))
        for f in fams], dim=1)
    conv = torch.cat([_conv(sc, f).reshape(n_isl, -1) for f in fams], dim=1)
    ii = torch.arange(n_isl, device=t_rows.device)[:, None]
    cand = {f: {"keys": _keys(family, sc, f)[ii, picks].cpu(),
                "valid": sc[f + "_valid"][ii, picks].cpu(),
                "conv": _conv(sc, f)[ii, picks].cpu()}
            for f in fams}
    delta, exact = out[0], out[1]
    win = common.lex_argmin(keys)
    return {"picks": picks.cpu(), "cand": cand, "widths": widths,
            "t_rows": t_rows.cpu(), "t_valid": t_valid.cpu(),
            "row_tabu": row_tabu.cpu(),
            "span_cap": getattr(cfg, "kd", None),
            "winner": win.cpu(),
            "win_key": keys[ii[:, 0], win].cpu(),
            "win_conv": conv[ii[:, 0], win].cpu(),
            "delta": {k: v.cpu() for k, v in delta.items()},
            "exact": exact.cpu()}


def _winner_move(data, i):
    """(family, target stop, candidate) of island i's winner: its flat
    index in the port's order (family, target, candidate)."""
    flat = int(data["winner"][i])
    widths = data["widths"]
    t_n = data["t_rows"].shape[1]
    fam = 0
    while fam < len(widths) - 1 and flat >= t_n * widths[fam]:
        flat -= t_n * widths[fam]
        fam += 1
    return fam, int(data["t_rows"][i, flat // widths[fam]]), flat % widths[fam]


def _key_miss(family, keys, ref, conv):
    """bool [C]: keys [C, P] the rescore ref [C, P] contradicts."""
    miss = torch.zeros(keys.shape[0], dtype=torch.bool)
    for c, part in enumerate(family.key_parts):
        if part in family.bounded_parts:
            miss |= torch.where(conv, keys[:, c] != ref[:, c],
                                keys[:, c] > ref[:, c])
        else:
            miss |= keys[:, c] != ref[:, c]
    return miss


def judge(j):
    family, data = j.family, j.data
    fams = family.sweep_families
    cand_bad = winner_bad = 0
    for i in range(j.n_isl):
        rep_i = j.island(i)
        base_ints = family.ints(rep_i)
        info = {"row_tabu": data["row_tabu"][i].to(j.device),
                "route_width": j.width,
                "span_cap": data["span_cap"] or family.n}
        for s, ti in enumerate(data["picks"][i].tolist()):
            t = int(data["t_rows"][i, ti])
            cands, valid = family.sweep_candidates(rep_i, t, info)
            valid = valid.cpu() & bool(data["t_valid"][i, ti])
            keys = j.program(
                torch.cat([data["cand"][f]["keys"][i, s] for f in fams]),
                lambda f: f.ints(cands) - f.ints(rep_i))
            pvalid = torch.cat([data["cand"][f]["valid"][i, s]
                                for f in fams])
            conv = torch.cat([data["cand"][f]["conv"][i, s] for f in fams])
            ref = (family.ints(cands) - base_ints).cpu()
            cand_bad += int(torch.sum(valid != pvalid))
            cand_bad += int(torch.sum(valid & pvalid
                                      & _key_miss(family, keys, ref, conv)))

        # the winner: the lexicographic minimum of the port's keys, rebuilt
        # by the reference's move semantics; its key is held to the rescore
        # like a sampled candidate's, wherever its target lies
        win = family.sweep_apply(rep_i, *_winner_move(data, i))
        ref = (family.ints(win) - base_ints).cpu()
        ok = int(data["exact"][i, 0]) != common.STUB
        if ok:
            def moved(f):
                return f.ints(win) - f.ints(rep_i)
            exact = j.program(data["exact"][i:i + 1], moved).long()
            key = j.program(data["win_key"][i:i + 1], moved)
            delta = {k: v[i:i + 1].to(j.device)
                     for k, v in data["delta"].items()}
            got = family.rep(check.apply_delta(j.base[i:i + 1], delta))
            bad = (not check.same_rep(win, got)
                   or not torch.equal(exact, ref)
                   or bool(_key_miss(family, key, ref,
                                     data["win_conv"][i:i + 1]).any()))
        else:
            # a stub is right only where no candidate was valid or the
            # move (or the base) overfills the port's route buffers
            bad = not (int(data["win_key"][i, 0]) == common.STUB
                       or bool(family.overfills(win, j.width).any())
                       or bool(family.overfills(rep_i, j.width).any()))
        winner_bad += int(bad)
        winner_bad += j.post_differs(i, win if ok and j.kept(i, win)
                                     else rep_i)
    return cand_bad, winner_bad
