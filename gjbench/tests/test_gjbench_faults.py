"""A run with the timed path broken underneath comes out not correct: the
harness's look for a card is skipped (the tiny cells run on the CPU), the
rest of the run is the card's. The faults a cell can have here:

  unchanged   every step returns its state unchanged;
  half        half of the candidates are not scored: their rows are the
              mean of the rest's;
  answer      the returned score is off by one thousandth where the solver
              produces it;
  winner      the winning candidate's row is off by one where it is
              produced (one thousandth of the distance);
  optimistic  (sweep) one candidate's key is made the best of all where
              the sweep scores it, so it wins whatever its true score and
              wherever its target lies: the step still applies and
              re-scores it exactly, and only the winner's own key shows
              the fault.

No cell spans chips, so there is no exchange between chips to leave out.
"""

import time

import pytest
import torch

from gjbench import check, harness
from gjbench.tests import _tiny


def _mean_rest(x, dim):
    """x with its second half along `dim` replaced by the mean of the
    first half (rounded for integer rows)."""
    n = x.shape[dim]
    first = x.narrow(dim, 0, n // 2)
    mean = first.double().mean(dim=dim, keepdim=True)
    if not x.dtype.is_floating_point:
        mean = torch.round(mean)
    out = x.clone()
    out.narrow(dim, n // 2, n - n // 2).copy_(
        mean.to(x.dtype).expand_as(out.narrow(dim, n // 2, n - n // 2)))
    return out


def plant(patch, fault, cell):
    """Break the port underneath for this run."""
    from greyjack_tpu_torch.agents import base
    from greyjack_tpu_torch.models.tsp import sweep as tsp_sweep
    from greyjack_tpu_torch.models.vrp import sweep as vrp_sweep
    from greyjack_tpu_torch.score_calculation.score_requesters import (
        ScoreRequester)
    from greyjack_tpu_torch.solver import solver as solver_mod

    path = _tiny.CELLS[cell][1]["path"]
    sweep = tsp_sweep if cell.startswith("tsp") else vrp_sweep
    if fault == "unchanged":
        init = base.MetaheuristicKernel.__init__

        def frozen(self, *a, **k):
            init(self, *a, **k)
            self.step = lambda generators, state, extras: state

        patch.set(base.MetaheuristicKernel, "__init__", frozen)
    elif fault == "answer":
        convert = solver_mod._convert_to_json

        def off(vm, row, score):
            out = convert(vm, row, score)
            out[1] = dict(out[1])
            key = list(out[1])[-1]
            out[1][key] = out[1][key] + 0.001
            return out

        patch.set(solver_mod, "_convert_to_json", off)
    elif path == "sweep":
        if fault == "optimistic":
            score = sweep.score_candidates

            def optimistic(*a, **k):
                sc = dict(score(*a, **k))
                fam = next(f for f in ("c", "a") if f + "_valid" in sc)
                valid = sc[fam + "_valid"]
                flat = valid.reshape(valid.shape[0], -1)
                first = torch.argmax(flat.to(torch.int32), dim=1)
                isl = torch.arange(flat.shape[0])
                for key in [k for k in sc if k.startswith(fam + "_")
                            and k[len(fam) + 1:] in ("hard", "late",
                                                     "dist")]:
                    v = sc[key].reshape(flat.shape).clone()
                    v[isl, first] = sc[key].min() - 1
                    sc[key] = v.reshape(sc[key].shape)
                return sc

            patch.set(sweep, "score_candidates", optimistic)
        elif fault == "half":
            score = sweep.score_candidates

            def half(*a, **k):
                sc = score(*a, **k)
                return {key: (_mean_rest(v, 1) if key[1:] in (
                    "_hard", "_late", "_dist") else v)
                    for key, v in sc.items()}

            patch.set(sweep, "score_candidates", half)
        else:
            propose = sweep.propose_from_targets

            def winner(*a, **k):
                delta, exact, info, stats = propose(*a, **k)
                live = exact[:, 0] != check.common.STUB
                exact = exact.clone()
                exact[:, -1] = torch.where(live, exact[:, -1] - 1,
                                           exact[:, -1])
                return delta, exact, info, stats

            patch.set(sweep, "propose_from_targets", winner)
    elif path == "int-delta":
        ints = ScoreRequester.request_score_delta_ints

        def broken(self, ctx, deltas):
            out = ints(self, ctx, deltas)
            if fault == "half":
                return _mean_rest(out, 1)
            best = check.common.lex_argmin(out)
            out = out.clone()
            isl = torch.arange(out.shape[0])
            out[isl, best, -1] -= 1
            return out

        patch.set(ScoreRequester, "request_score_delta_ints", broken)
    else:
        propose = base.PlainMoveStep.propose

        def broken(self, generators, state, candidates):
            moved, info, scores = propose(self, generators, state, candidates)
            if fault == "half":
                return moved, info, _mean_rest(scores, 1)
            best = check.common.lex_argmin(scores)
            scores = scores.clone()
            isl = torch.arange(scores.shape[0])
            scores[isl, best, -1] -= 0.001
            return moved, info, scores

        patch.set(base.PlainMoveStep, "propose", broken)


FAULTS = ["unchanged", "half", "answer", "winner"]
CASES = [(cell, fault) for cell in sorted(_tiny.CELLS) for fault in FAULTS
         ] + [(cell, "optimistic") for cell in sorted(_tiny.CELLS)
              if _tiny.CELLS[cell][1]["path"] == "sweep"]


def _run(root, cell):
    result, _ = harness.run(root, cell, 4242, 0.6, False, "cpu",
                            time.perf_counter())
    return result, {k for k, v in result["checks"].items()
                    if v["value"] > v["limit"]}


@pytest.mark.parametrize("cell,fault", CASES)
def test_a_broken_path_is_not_correct(tiny_root, cell, fault):
    patch = check.Patch()
    plant(patch, fault, cell)
    try:
        result, over = _run(tiny_root, cell)
    finally:
        patch.close()
    assert not result["correct"] and over, result["checks"]
    if fault == "optimistic":
        assert "winner_bad" in over, result["checks"]


@pytest.mark.parametrize("cell", sorted(_tiny.CELLS))
def test_a_path_without_a_file_gets_the_common_checks(tiny_root, cell,
                                                      monkeypatch):
    """A cell whose path has no file under gjbench/paths is judged by the
    checks every path has, and a sound run of it is correct."""
    monkeypatch.setattr(check, "path_module", lambda name: None)
    result, over = _run(tiny_root, cell)
    assert result["correct"] and not over, result["checks"]
    assert {"final_score_gap", "not_improved", "capture_missing",
            "state_bad"} <= set(result["checks"])
    assert not {"cand_bad", "winner_bad"} & set(result["checks"])
