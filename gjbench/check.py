"""What decides `correct`: one step of the timed solve, observed as it runs,
and the solution the solve returns, both judged by the plain reference.

The observed step is the last step of the timed solve's first chunk. That
chunk lies outside the measured window (the window starts when the second
chunk does), so the copies the observation makes cost the window nothing.
On every path the island states before and after the step are kept. What
else is kept of the step, and how it is judged, belongs to the kernel's
path and sits in `gjbench/paths/<path>.py` (the workload's "path", with
"-" written "_"): `observe(capture)` hooks the port's functions,
`reduce(capture, seen, n_islands)` keeps a sample drawn from the seed and
the winner, `judge(judging)` returns (cand_bad, winner_bad). Whether the
step had to keep its winner is the agent's acceptance rule,
`gjbench/accept/<rule>.py` (the workload's check "accept"), judged on the
reference's own scores.

A path with no file of its own gets the checks every path has: the
returned score, the start, the stored scores and the delta ctx. Every
number compared is a count of disagreements (limit 0) but
`final_score_gap`, the largest gap between the returned score and the
reference's rescore of the returned solution (limit 0: both are exact
integer arithmetic scaled once).

The lower-precision control runs the same judge with `control`, the
reference computed in float32: every value the judge takes from the port
(the returned score, the stored scores, the ctx's distance total, the
sampled candidates' rows and keys, the winner's) becomes the float32
reference's, by the recipe the reference uses; the port's choices stay.
"""

from __future__ import annotations

import importlib

import numpy as np
import torch

from gjbench.reference import common

# every number compared, with its limit (`path_bad`, the kernel's path
# against the cell's, is the harness's)
LIMITS = {"final_score_gap": 0, "not_improved": 0, "capture_missing": 0,
          "state_bad": 0, "cand_bad": 0, "winner_bad": 0, "ctx_bad": 0,
          "path_bad": 0}


class Patch:
    """Attributes replaced for a while and put back by `close`."""

    def __init__(self):
        self.saved = []

    def set(self, obj, attr, value):
        self.saved.append((obj, attr, getattr(obj, attr)))
        setattr(obj, attr, value)

    def close(self):
        while self.saved:
            obj, attr, value = self.saved.pop()
            setattr(obj, attr, value)


def path_module(name):
    """The module of path `name` under `gjbench/paths`, or None."""
    mod = "gjbench.paths." + name.replace("-", "_")
    try:
        return importlib.import_module(mod)
    except ModuleNotFoundError as e:
        if e.name != mod:
            raise
        return None


def accept_rule(name):
    """The module of acceptance rule `name` under `gjbench/accept`."""
    return importlib.import_module("gjbench.accept." + name)


def _state(state):
    """Copies of an island state: the first individual's row and score,
    the delta ctx, and the state's other tensors (tabu lists, counters)."""
    keep = {"pop": state["population"][:, 0].clone(),
            "score": state["scores"][:, 0].clone(),
            "state": {k: v.clone() for k, v in state.items()
                      if torch.is_tensor(v)
                      and k not in ("population", "scores")}}
    if "ctx" in state:
        keep["ctx"] = {k: v.clone() for k, v in state["ctx"].items()}
    return keep


def sample(rng, n_islands, total, count):
    """int64 [I, count]: distinct indices below `total` for each island."""
    count = min(count, total)
    return torch.as_tensor(np.stack([
        np.sort(rng.choice(total, size=count, replace=False))
        for _ in range(n_islands)]))


def sample_rows(capture, cands, rows, n_isl):
    """What a path scored as rows keeps: the rows and candidates of a
    sample drawn from the seed, and the winner (the lexicographic minimum
    of the port's own rows)."""
    dev = rows.device
    picks = sample(capture.rng, n_isl, rows.shape[1], capture.count).to(dev)
    ii = torch.arange(n_isl, device=dev)[:, None]
    win = common.lex_argmin(rows)
    isl = ii[:, 0]
    return {"picks": picks.cpu(),
            "cand": {k: v[ii, picks].cpu() for k, v in cands.items()},
            "rows": rows[ii, picks].cpu(),
            "winner": win.cpu(),
            "win_cand": {k: v[isl, win].cpu() for k, v in cands.items()},
            "win_row": rows[isl, win].cpu()}


class Capture:
    """Observes one step of the timed solve. `arm(runner)` at the entry of
    the first chunk, `disarm()` when it returns."""

    def __init__(self, family, workload, rng):
        # the family's class: its sweep module and candidate key names
        self.family = family
        self.path = path_module(workload["path"])
        self.step_at = workload["chunk_steps"] - 1
        self.count = workload["check"]["sample"]
        self.rng = rng
        self.patch = Patch()
        self.live = False
        self.data = None
        self.seen = {}

    def arm(self, runner):
        kernel = runner.kernel
        # the agent's settings, for the acceptance rule
        builder = {k: v for k, v in vars(kernel.builder).items()
                   if isinstance(v, (bool, int, float, str))}
        step = kernel.step
        calls = [0]

        def observed_step(generators, state, extras):
            calls[0] += 1
            if calls[0] - 1 != self.step_at:
                return step(generators, state, extras)
            pre = _state(state)
            self.live = True
            try:
                out = step(generators, state, extras)
            finally:
                self.live = False
            seen, self.seen = self.seen, {}
            self.data = {"pre": pre, "post": _state(out), "builder": builder}
            if self.path is not None:
                self.data.update(self.path.reduce(self, seen,
                                                  pre["pop"].shape[0]))
            return out

        self.patch.set(kernel, "step", observed_step)
        if self.path is not None:
            self.path.observe(self)

    def disarm(self):
        self.patch.close()

    def watch(self, owner, attr, key, args=False):
        """Keep what `owner.attr` returns (and its arguments, with `args`)
        during the observed step, under `key`."""
        fn = getattr(owner, attr)

        def wrapped(*a, **k):
            out = fn(*a, **k)
            if self.live:
                self.seen[key] = (a, out) if args else out
            return out

        self.patch.set(owner, attr, wrapped)


def apply_delta(rows, delta):
    """rows int64 [B, V] with each delta (positions / values / valid
    [B, K]) written in order, later entries winning."""
    rows = rows.clone()
    pos = delta["positions"].long()
    val = torch.round(delta["values"].double()).long()
    for k in range(pos.shape[1]):
        cur = torch.gather(rows, 1, pos[:, k:k + 1])
        new = torch.where(delta["valid"][:, k:k + 1], val[:, k:k + 1], cur)
        rows.scatter_(1, pos[:, k:k + 1], new)
    return rows


def same_rep(a, b):
    return all(torch.equal(x.long().cpu(), y.long().cpu())
               for x, y in zip(a, b))


class Judging:
    """What a path's judge reads: the reference side (`family`), the
    observed step (`data`), the base solution of each island, and the
    port's side of every number compared (`program`)."""

    def __init__(self, family, data, workload, device, control=None):
        self.family = family
        self.data = data
        self.device = device
        self.precision = workload.get("score_precision")
        self.control = control
        self.rule = accept_rule(workload["check"]["accept"])
        self.base = data["pre"]["pop"].to(device).long()
        self.base_rep = family.rep(self.base)
        self.n_isl = self.base.shape[0]
        self.width = family.route_width(data["pre"].get("ctx"))

    def program(self, captured, recipe):
        """The port's value `captured`; under the control, `recipe` (a
        function of a reference side) computed by the float32 reference."""
        if self.control is None:
            return captured
        return recipe(self.control).cpu().to(captured.dtype)

    def island(self, i):
        return tuple(x[i:i + 1] for x in self.base_rep)

    def kept(self, i, win):
        """Whether island i's step has to keep its winner `win`, by the
        acceptance rule on the reference's scores."""
        rows = [self.family.rows(r, self.precision)[0].tolist()
                for r in (win, self.island(i))]
        return bool(self.rule.keeps(rows[0], rows[1],
                                    self.data["pre"]["state"], i,
                                    self.data["builder"]))

    def post_differs(self, i, want):
        """1 where island i's solution after the step is not `want`."""
        post = self.family.rep(self.data["post"]["pop"][i:i + 1]
                               .to(self.device))
        return int(not same_rep(want, post))

    def state_bad(self):
        """Stored scores that are not their island's solution's."""
        bad = 0
        for st in (self.data["pre"], self.data["post"]):
            rep = self.family.rep(st["pop"].to(self.device))
            want = self.family.rows(rep, self.precision).cpu()
            got = self.program(st["score"],
                               lambda f: f.rows(rep, self.precision))
            bad += int(torch.sum(torch.any(want != got.cpu(), dim=1)))
        return bad

    def ctx_bad(self):
        """Delta-ctx entries after the step that differ from the
        reference's view of the stepped solution."""
        post = self.data["post"]
        rep = self.family.rep(post["pop"].to(self.device))
        ctx = dict(post["ctx"])
        total = self.family.ctx_total
        ctx[total] = self.program(ctx[total], lambda f: f.ints(rep)[:, -1])
        ctx = {k: v.cpu().numpy() for k, v in ctx.items()}
        return sum(self.family.ctx_bad({k: v[i] for k, v in ctx.items()},
                                       tuple(x[i:i + 1] for x in rep))
                   for i in range(self.n_isl))


def judge(family, data, final_row, final_score, workload, device,
          control=None):
    """The numbers compared, each as {value, limit}.

    family: the reference side of the instance (families/*.Family);
    data: `Capture.data` (None when the step was not observed);
    final_row: int64 [V] the returned solution; final_score: the returned
    score row (list); workload: the cell's workload file; control: the
    float32 reference side, for the control, or None."""
    precision = workload.get("score_precision")
    out = {}
    fin_rep = family.rep(torch.as_tensor(final_row)[None].to(device))
    fin = family.rows(fin_rep, precision)[0].cpu().numpy()
    if control is not None:
        final_score = control.rows(fin_rep, precision)[0].tolist()
    got = np.asarray(final_score, np.float64)
    out["final_score_gap"] = (float(np.max(np.abs(got - fin)))
                              if np.all(np.isfinite(got)) else float("inf"))
    start = family.start()
    if start is None:
        out["not_improved"] = 0
    else:
        st = family.rows(family.rep(torch.as_tensor(start)[None].to(device)),
                         precision)[0].cpu().numpy()
        out["not_improved"] = int(not common.lex_less(list(got), list(st)))
    path = path_module(workload["path"])
    if not data or (path is not None and "winner" not in data):
        out["capture_missing"] = 1
        return {k: {"value": v, "limit": LIMITS[k]} for k, v in out.items()}
    out["capture_missing"] = 0
    judging = Judging(family, data, workload, device, control)
    out["state_bad"] = judging.state_bad()
    if path is not None:
        out["cand_bad"], out["winner_bad"] = path.judge(judging)
    if "ctx" in data["post"]:
        out["ctx_bad"] = judging.ctx_bad()
    return {k: {"value": v, "limit": LIMITS[k]} for k, v in out.items()}
