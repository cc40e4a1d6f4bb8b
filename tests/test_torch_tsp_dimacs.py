"""The TSP sweep at the DIMACS Challenge's magnitudes (points in the
10^6 x 10^6 square, legs up to 1.4e9 thousandths): the sweep engages, its
sums and keys are i64 and every candidate's key equals a plain rescore by
the benchmark's reference (`gjbench/reference/tsp.py`), a whole-tour
winner updates the ctx to the reference's view of the stepped tour, and a
short solve returns the rescore of its tour. Instances of the benchmark's
`tsp-n1000` size keep the i32 path; the gate and the flat matrix indices
are checked at their limits."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from gjbench.families import tsp as fam_tsp
from greyjack_tpu_torch.agents import TabuSearch
from greyjack_tpu_torch.agents.termination_strategies import StepsLimit
from greyjack_tpu_torch.models.tsp import (CotwinBuilder, DomainBuilder,
                                           generate_uniform_instance)
from greyjack_tpu_torch.models.tsp import cotwin_builder as tcb
from greyjack_tpu_torch.models.tsp import sweep as tsweep
from greyjack_tpu_torch.ops import moves
from greyjack_tpu_torch.score_calculation.score_requesters import (
    ScoreRequester)
from greyjack_tpu_torch.solver import (Solver, SolverLoggingLevels,
                                       SolverMetrics)

torch.set_num_threads(1)

_N = 300                      # locations: 299 tour rows
_SPAN = 1e6                   # the Challenge's square
_SEED = 17
_PROBAS = [0.0, 0.2, 0.2, 0.2, 0.2, 0.2]
_FAMS = ("a", "c", "r", "i")


def _domain(n=_N, span=_SPAN):
    return generate_uniform_instance(n, seed=_SEED, span=span, device="cpu")


def _family(domain, cfg):
    """The reference's side of the instance."""
    inst = {"xs": np.array([lc.latitude for lc in domain.locations_vec]),
            "ys": np.array([lc.longitude for lc in domain.locations_vec]),
            "name": "e300"}
    return fam_tsp.Family(inst, "cpu", {"stop": cfg.var_ids.tolist()})


@pytest.fixture(scope="module")
def e300():
    domain = _domain()
    req = ScoreRequester(CotwinBuilder(True, True).build_cotwin(domain,
                                                                False))
    cfg = tsweep.SweepConfig(req, 64)
    return SimpleNamespace(req=req, cfg=cfg, utils=req._delta_utils(),
                           family=_family(domain, cfg),
                           greedy=req.variables_manager.initial_values)


def _perturbed(greedy, rng, n_isl=2):
    """The greedy tour with a few seeded swaps, a duplicate stop on the
    second island."""
    out = greedy.clone()[None].repeat(n_isl, 1)
    for i in range(n_isl):
        for _ in range(8):
            x, y = rng.integers(out.shape[1], size=2)
            out[i, [x, y]] = out[i, [y, x]]
    out[1, 3] = out[1, 7]
    return out


def test_the_sweep_engages_and_every_key_is_the_rescore(e300):
    req, cfg, family = e300.req, e300.cfg, e300.family
    assert e300.utils["dm_max_milli"] >= 1 << 24    # past the JAX gate
    assert tsweep.eligible(e300.utils) and req.supports_sweep
    assert cfg.acc == torch.int64 and cfg.kd == _N - 1
    rng = np.random.default_rng(3)
    bases = _perturbed(e300.greedy, rng)
    ctx = req.build_base_ctx(bases)
    n = cfg.n_rows
    t_rows = torch.as_tensor(np.stack([rng.permutation(n)[:3]
                                       for _ in range(2)]), dtype=torch.int32)
    t_valid = torch.ones(t_rows.shape, dtype=torch.bool)
    row_tabu = torch.as_tensor(rng.random((2, n)) < 0.1)
    row_tabu[torch.arange(2)[:, None], t_rows.long()] = False
    sc = tsweep.score_candidates(ctx, t_rows, t_valid, row_tabu, cfg,
                                 e300.utils)
    assert {sc[f + "_dist"].dtype for f in _FAMS} == {torch.int64}
    rows = bases.long()
    widest = 0
    for i in range(2):
        rep = family.rep(rows[i:i + 1])
        base_ints = family.ints(rep)
        for ti in range(t_rows.shape[1]):
            cands, valid = family.sweep_candidates(
                rep, int(t_rows[i, ti]), {"row_tabu": row_tabu[i],
                                          "span_cap": cfg.kd})
            ref = family.ints(cands) - base_ints
            keys = torch.cat([torch.stack([sc[f + "_hard"][i, ti].long(),
                                           sc[f + "_dist"][i, ti]], -1)
                              for f in _FAMS])
            got_valid = torch.cat([sc[f + "_valid"][i, ti] for f in _FAMS])
            assert torch.equal(got_valid, valid)
            assert torch.equal(keys[valid], ref[valid])
            widest = max(widest, int(ref[valid, 1].abs().max()))
    # the i32 sums of the JAX package's instances would have wrapped here
    assert widest >= 1 << 31


def _long_move_bases(greedy):
    """Island 0: the greedy tour with positions 20..250 reversed; island 1:
    the city at position 5 moved to sit after position 280."""
    b0 = greedy.clone()
    b0[20:251] = b0[20:251].flip(0)
    b1 = greedy.tolist()
    b1.insert(280, b1.pop(5))
    return torch.stack([b0, torch.as_tensor(b1, dtype=greedy.dtype)])


def test_a_whole_tour_winner_updates_the_ctx_to_the_reference(e300):
    req, cfg, family = e300.req, e300.cfg, e300.family
    bases = _long_move_bases(e300.greedy)
    ctx = req.build_base_ctx(bases)
    n = cfg.n_rows
    t_rows = torch.arange(n, dtype=torch.int32).repeat(2, 1)
    delta, exact, _, _ = tsweep.propose_from_targets(
        ctx, t_rows, torch.ones((2, n), dtype=torch.bool),
        torch.zeros((2, n), dtype=torch.bool), cfg, e300.utils)
    assert exact.dtype == torch.int64
    assert (delta["valid"].sum(-1) > 8).all()     # both winners are wide
    patched = moves.apply_delta(bases, delta)
    after = req.update_ctx(ctx, delta)
    rebuilt = req.build_base_ctx(patched)
    for key, value in rebuilt.items():
        assert torch.equal(after[key], value), key
    for i in range(2):
        rep = family.rep(patched[i:i + 1].long())
        view = {k: v[i].numpy() for k, v in after.items()}
        assert family.ctx_bad(view, rep) == 0
        moved = family.ints(rep) - family.ints(family.rep(
            bases[i:i + 1].long()))
        assert torch.equal(moved[0], exact[i])
    # the reversal and the insertion that undo the bases win
    assert torch.equal(patched, e300.greedy[None].repeat(2, 1))


def test_a_short_solve_returns_the_rescore_of_its_tour(e300):
    agent = TabuSearch(64, 0.5, True, None, _PROBAS, 5, StepsLimit(14),
                       sweep=True, sweep_targets=16)
    metrics = SolverMetrics()
    sol = Solver.solve(DomainBuilder.from_generator(_domain),
                       CotwinBuilder(True, True), agent, 2,
                       score_precision=[3, 3], seed=9, metrics=metrics,
                       logging_level=SolverLoggingLevels.Silent)
    assert {r["kernel_path"] for r in metrics.records} == {"sweep"}
    row = torch.as_tensor([[v for _, v in sol[0]]], dtype=torch.int64)
    family = e300.family
    want = family.rows(family.rep(row), [3, 3])[0].tolist()
    assert want == [sol[1]["hard_score"], sol[1]["soft_score"]]
    start = torch.as_tensor(family.start())[None]
    assert want < family.rows(family.rep(start), [3, 3])[0].tolist()


def test_benchmark_sized_instances_keep_the_i32_path():
    """1000 locations in the 100 x 100 square (`tsp-n1000`): i32 sums,
    keys and exact row, as the JAX package has them."""
    domain = _domain(1000, 100.0)
    req = ScoreRequester(CotwinBuilder(True, True).build_cotwin(domain,
                                                                False))
    cfg = tsweep.SweepConfig(req, 2)
    utils = req._delta_utils()
    assert cfg.acc == torch.int32
    ctx = req.build_base_ctx(req.variables_manager.initial_values[None])
    t_rows = torch.tensor([[5, 600]], dtype=torch.int32)
    out = tsweep.propose_from_targets(
        ctx, t_rows, torch.ones((1, 2), dtype=torch.bool),
        torch.zeros((1, cfg.n_rows), dtype=torch.bool), cfg, utils)
    sc = tsweep.score_candidates(
        ctx, t_rows, torch.ones((1, 2), dtype=torch.bool),
        torch.zeros((1, cfg.n_rows), dtype=torch.bool), cfg, utils)
    assert {sc[f + "_dist"].dtype for f in _FAMS} == {torch.int32}
    assert out[1].dtype == torch.int32


def test_the_gate_and_the_sums_dtype_at_their_limits():
    assert tsweep.eligible({"dm_max_milli": (1 << 31) - 1})
    assert not tsweep.eligible({"dm_max_milli": 1 << 31})
    assert not tsweep.eligible({})               # no bound: no sweep
    six = ((1 << 31) - 1) // 6
    assert tsweep.acc_dtype({"dm_max_milli": six}, 5) == torch.int32
    assert tsweep.acc_dtype({"dm_max_milli": six + 1}, 5) == torch.int64
    tour = ((1 << 31) - 1) // 1001
    assert tsweep.acc_dtype({"dm_max_milli": tour}, 1000) == torch.int32
    assert tsweep.acc_dtype({"dm_max_milli": tour + 1}, 1000) == torch.int64


class _Matrix:
    """Stands in for an L x L milli matrix too large to hold: records the
    indices it is read at and reads 1 everywhere (flat: one value an
    index; `rows`: a whole row an index)."""

    def __init__(self, l, rows=False):
        self.l = l
        self.rows = rows
        self.seen = []

    def __getitem__(self, idx):
        self.seen.append(idx.clone())
        shape = idx.shape + ((self.l,) if self.rows else ())
        return torch.ones(shape, dtype=torch.int32)

    def flat_pairs(self):
        idx = torch.cat([x.reshape(-1) for x in self.seen])
        assert idx.dtype == torch.int64 and int(idx.min()) >= 0
        assert int(idx.max()) < self.l * self.l
        return idx // self.l, idx % self.l


def test_flat_indices_past_46341_locations_do_not_wrap():
    """L = 50,000: L * L passes 2^31, so an i32 flat index would wrap.
    The ctx build, the delta analysis (narrow and whole-tour) and the
    sweep read the matrix only at (from, to) pairs of the tour."""
    l, n = 50_000, 400
    rng = np.random.default_rng(1)
    tour = torch.as_tensor(rng.choice(np.arange(l - 2000, l), size=(2, n),
                                      replace=False), dtype=torch.int32)
    dmf = _Matrix(l)
    utils = {"n_locations": l, "dm_flat_milli": dmf,
             "delta_schema": {"var_row": torch.arange(n, dtype=torch.int32)}}
    ctx = tcb.build_delta_ctx({"path_stops": {"locations_vec_id": tour}},
                              None, utils)
    src, dst = dmf.flat_pairs()
    zero = torch.zeros((2, 1), dtype=torch.int64)
    assert torch.equal(src, torch.cat([zero, tour.long()], 1).reshape(-1))
    assert torch.equal(dst, torch.cat([tour.long(), zero], 1).reshape(-1))

    stops = set(tour.reshape(-1).tolist()) | {0}
    for k in (2, n):
        dmf.seen.clear()
        pos = torch.as_tensor(np.stack([rng.permutation(n)[:k]
                                        for _ in range(2)]), dtype=torch.int32)
        values = torch.gather(tour, 1, pos.flip(-1).long()).float()
        delta = {"positions": pos, "values": values,
                 "valid": torch.ones(pos.shape, dtype=torch.bool)}
        tcb.update_ctx(ctx, delta, utils)
        src, dst = dmf.flat_pairs()
        assert int((src * l + dst).max()) >= 1 << 31
        assert set(src.tolist()) <= stops and set(dst.tolist()) <= stops

    dmf.seen.clear()
    cfg = SimpleNamespace(dm=_Matrix(l, rows=True), dmT=_Matrix(l, rows=True),
                          n_rows=n, kd=n, acc=torch.int64)
    t_rows = torch.tensor([[3, 200], [0, n - 1]], dtype=torch.int32)
    tsweep.score_candidates(ctx, t_rows, torch.ones((2, 2), dtype=torch.bool),
                            torch.zeros((2, n), dtype=torch.bool), cfg, utils)
    src, dst = dmf.flat_pairs()
    assert int((src * l + dst).max()) >= 1 << 31
    assert set(src.tolist()) <= stops and set(dst.tolist()) <= stops
