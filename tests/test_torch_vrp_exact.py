"""`exact_fp_scores=True`, torch port vs the JAX package: the VRP plain
score through the sequential f64 fold (`ops/routes.py` `vrp_routes`,
`_seq_sum`) must be bit-equal to the JAX package's eager exact branch, on
the time-windowed and the plain instance. The cotwin registers no delta
kernels (as in the JAX package), so every agent runs its plain path.
Tolerance: none."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from greyjack_tpu.models.vrp import CotwinBuilder as JCotwinBuilder
from greyjack_tpu.models.vrp import generate_instance as j_generate
from greyjack_tpu.ops import routes as jroutes
from greyjack_tpu.score_calculation.score_requesters import (
    ScoreRequester as JScoreRequester)

from _port_parity import assert_leaf_equal
from greyjack_tpu_torch.agents import GeneticAlgorithm, TabuSearch
from greyjack_tpu_torch.agents.termination_strategies import StepsLimit
from greyjack_tpu_torch.models.vrp import (CotwinBuilder, DomainBuilder,
                                           generate_instance)
from greyjack_tpu_torch.ops import routes
from greyjack_tpu_torch.score_calculation.score_requesters import (
    ScoreRequester)
from greyjack_tpu_torch.solver import Solver, SolverLoggingLevels, SolverMetrics

torch.set_num_threads(1)


def _pair(tw, n=40, d=2, k=6, seed=3, greedy=True):
    jd = j_generate(n, d, k, seed=seed, time_windowed=tw)
    td = generate_instance(n, d, k, seed=seed, time_windowed=tw,
                           device="cpu")
    jreq = JScoreRequester(JCotwinBuilder(True, greedy, exact_fp_scores=True)
                           .build_cotwin(jd, False))
    treq = ScoreRequester(CotwinBuilder(True, greedy, exact_fp_scores=True)
                          .build_cotwin(td, False))
    return jreq, treq


def _population(treq, rows, seed):
    vm = treq.variables_manager
    rng = np.random.default_rng(seed)
    lo = vm.lower_bounds.numpy()
    hi = vm.upper_bounds.numpy()
    pop = np.floor(lo + rng.random((rows, lo.shape[0])) * (hi - lo + 1))
    pop = pop.astype(np.float32)
    pop[0] = vm.initial_values.numpy()
    # most stops on one vehicle, one vehicle empty, out-of-range entries
    pop[1, 0::2] = 0
    pop[2, 0::2] = np.where(pop[2, 0::2] == 1, 2, pop[2, 0::2])
    pop[3, 0] = hi[0] + 5
    pop[3, 1] = 2.5
    return pop


@pytest.mark.parametrize("tw", [True, False])
def test_exact_plain_scores_bit_equal(tw):
    jreq, treq = _pair(tw)
    assert not treq.supports_delta and not jreq.supports_delta
    pop = _population(treq, 24, seed=7 + tw)
    want = np.asarray(jreq.request_score_plain(jnp.asarray(pop)))
    got = treq.request_score_plain(torch.from_numpy(pop))
    assert_leaf_equal(want, got, "exact scores")
    # the fast walk agrees on the integer levels and to rounding on soft
    fast = ScoreRequester(CotwinBuilder(False, True).build_cotwin(
        generate_instance(40, 2, 6, seed=3, time_windowed=tw, device="cpu"),
        False)).request_score_plain(torch.from_numpy(pop))
    assert torch.equal(fast[:, :2], got[:, :2])
    np.testing.assert_allclose(fast[:, 2].numpy(), got[:, 2].numpy(),
                               rtol=1e-12)


@pytest.mark.parametrize("tw", [True, False])
def test_vrp_routes_bit_equal_to_jax(tw):
    """The fold itself on sorted stop lists, batched over rows, against
    the JAX `vrp_routes` of each row (empty vehicles included)."""
    jd = j_generate(30, 2, 5, seed=9, time_windowed=tw)
    td = generate_instance(30, 2, 5, seed=9, time_windowed=tw, device="cpu")
    jutils = JScoreRequester(JCotwinBuilder(False, False).build_cotwin(
        jd, False)).cotwin.score_calculator.utility_objects
    treq = ScoreRequester(CotwinBuilder(False, False).build_cotwin(td, False))
    tutils = treq.cotwin.score_calculator.utility_objects
    rng = np.random.default_rng(2)
    rows = 6
    v = np.sort(rng.integers(0, 5, (rows, 30)), axis=-1).astype(np.int32)
    v[0] = 3                                    # one vehicle holds all
    c = rng.integers(2, 32, (rows, 30)).astype(np.int32)
    tw_kw = {}
    if tw:
        tw_kw = dict(work_day_start=jutils["work_day_start"],
                     work_day_end=jutils["work_day_end"],
                     tw_start=jutils["tw_start"], tw_end=jutils["tw_end"],
                     service_time=jutils["service_time"])
    want = [jroutes.vrp_routes(jnp.asarray(v[i]), jnp.asarray(c[i]),
                               jutils["distance_matrix"],
                               jutils["vehicle_depot_ids"], 5, **tw_kw)
            for i in range(rows)]
    tc = torch.from_numpy(c)
    got = routes.vrp_routes(
        torch.from_numpy(v), tc, tutils["distance_matrix"],
        tutils["vehicle_depot_ids"], 5, tutils["work_day_start_k"],
        tutils["work_day_end_k"],
        tutils["cust_packed"][tc.long()] if tw else None)
    for i in range(rows):
        assert float(got[0][i]) == float(want[i][0])
        assert float(got[1][i]) == float(want[i][1])
    if tw:
        assert (got[1] > 0).any()


def test_seq_sum_is_a_left_fold():
    x = torch.tensor([[1e16, 1.0, -1e16, 1.0], [0.1, 0.2, 0.3, 0.4]],
                     dtype=torch.float64)
    got = routes._seq_sum(x)
    want = [float(jroutes._seq_sum(jnp.asarray(r.numpy()))) for r in x]
    assert got.tolist() == want
    assert got[0] == 1.0    # ((1e16 + 1) - 1e16) + 1 in f64


@pytest.mark.parametrize("agent", ["GA", "TS"])
def test_exact_solve_runs_plain_and_rescores(agent):
    def gen():
        return generate_instance(30, 2, 5, seed=3, time_windowed=True,
                                 device="cpu")

    if agent == "GA":
        make = GeneticAlgorithm(8, 0.5, 0.05, 0.2, None,
                                [0.5, 0.5, 0, 0, 0, 0], 0.1, 4, StepsLimit(7))
    else:
        make = TabuSearch(16, 0.2, True, None, [0.5, 0.5, 0, 0, 0, 0], 4,
                          StepsLimit(7))
    metrics = SolverMetrics()
    cb = CotwinBuilder(True, True, exact_fp_scores=True)
    sol = Solver.solve(DomainBuilder.from_generator(gen), cb, make, 2,
                       seed=5, logging_level=SolverLoggingLevels.Silent,
                       metrics=metrics)
    assert {r["kernel_path"] for r in metrics.records} == {"plain"}
    values = torch.tensor([[v for _, v in sol[0]]], dtype=torch.float32)
    req = ScoreRequester(cb.build_cotwin(gen(), False))
    assert req.request_score_plain(values)[0].tolist() == [
        sol[1]["hard_score"], sol[1]["medium_score"], sol[1]["soft_score"]]
