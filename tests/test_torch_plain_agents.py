"""The plain (full-rescore) TabuSearch, LateAcceptance and
SimulatedAnnealing steps of the torch port vs the JAX package.

With a cotwin that has no delta kernels every local-search agent takes its
plain branch: move, `fix_all`, one plain score call, accept. Fed the move
noise the JAX step draws from the same key (and, for SA, its accept
uniform), one port step gives the JAX step's whole state bit for bit —
population, f64 score rows, tabu rings, late-acceptance ring, temperature,
island best. Tolerance: none (f64 rows come from the same integer sums and
the same divisions; the SA probability is only compared through its
accept flags, which decide the state). Small `Solver.solve` runs of each
agent report path "plain" and a score equal to a plain rescore."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from greyjack_tpu.agents import (TabuSearch as JTS, LateAcceptance as JLA,
                                 SimulatedAnnealing as JSA)
from greyjack_tpu.agents.termination_strategies import StepsLimit as JSteps
from greyjack_tpu.ops import moves as jmoves

from _port_parity import (plain_pair, stack_states, assert_tree_equal,
                          jax_move_noise, jax_population_noise)
from greyjack_tpu_torch.agents import (TabuSearch, LateAcceptance,
                                       SimulatedAnnealing)
from greyjack_tpu_torch.agents import simulated_annealing as tsa
from greyjack_tpu_torch.agents.termination_strategies import StepsLimit
from greyjack_tpu_torch.interop import from_numpy_tree
from greyjack_tpu_torch.models.vrp import (CotwinBuilder, DomainBuilder,
                                           generate_instance)
from greyjack_tpu_torch.ops import moves as tmoves
from greyjack_tpu_torch.score_calculation.score_requesters import (
    ScoreRequester)
from greyjack_tpu_torch.solver import Solver, SolverLoggingLevels, SolverMetrics

_N_ISL = 2
_T0 = [1000.0, 1000.0, 1.0]


@pytest.fixture(scope="module")
def pair():
    return plain_pair()


def _agents(name, probas, cooling=0.9):
    if name == "TS":
        return (JTS(12, 0.2, True, None, probas, 5, JSteps(5)),
                TabuSearch(12, 0.2, True, None, probas, 5, StepsLimit(5)))
    if name == "LA":
        return (JLA(3, 0.2, None, probas, 5, JSteps(5)),
                LateAcceptance(3, 0.2, None, probas, 5, StepsLimit(5)))
    return (JSA(_T0, cooling, 0.2, None, probas, 5, JSteps(5)),
            SimulatedAnnealing(_T0, cooling, 0.2, None, probas, 5,
                               StepsLimit(5)))


@pytest.mark.parametrize("name,cooling", [("TS", None), ("LA", None),
                                          ("SA", 0.9), ("SA", None)])
@pytest.mark.parametrize("probas", [None, [0.5, 0.5, 0, 0, 0, 0]])
def test_plain_steps_bit_equal(pair, monkeypatch, name, cooling, probas):
    jreq, treq = pair
    ja, ta = _agents(name, probas, cooling)
    jk, tk = ja.build_kernel(jreq), ta.build_kernel(treq)
    assert jk.path == tk.path == "plain"
    assert not tk.self_gating
    jvm = jreq.variables_manager
    jcfg = jmoves.MoverConfig(jvm, 0.2, None, probas)
    n = tk.moves_per_step
    states = [jk.init_state(k)
              for k in jax.random.split(jax.random.key(3), _N_ISL)]
    extras_j = [{} for _ in range(_N_ISL)]
    extras_t = {}
    if name == "SA" and cooling is None:
        rates = [0.75, 0.25]
        extras_j = [{"inverted_accomplish_rate": jnp.float64(r)}
                    for r in rates]
        extras_t = {"inverted_accomplish_rate": torch.tensor(
            rates, dtype=torch.float64)}
    tstate = from_numpy_tree(stack_states(states), device="cpu")
    accepted = np.zeros(_N_ISL, bool)
    for step in range(3):
        keys = jax.random.split(jax.random.fold_in(jax.random.key(5), step),
                                _N_ISL)
        new = [jk.step(keys[i], states[i], extras_j[i])
               for i in range(_N_ISL)]
        k_moves = [jax.random.split(k)[0] for k in keys]
        noise = jax_population_noise(k_moves, jax_move_noise, jvm, jcfg,
                                     jnp.float32, n)
        monkeypatch.setattr(tmoves, "draw_move_noise",
                            lambda *a, **k: noise)
        u = torch.tensor([float(jax.random.uniform(
            jax.random.split(k)[1], (), dtype=jnp.float64)) for k in keys],
            dtype=torch.float64)
        monkeypatch.setattr(tsa, "accept_uniforms", lambda *a, **k: u)
        tstate = tk.step(None, tstate, extras_t)
        assert_tree_equal(stack_states(new), tstate, f"step {step}")
        accepted |= np.any(np.asarray(stack_states(new)["population"])
                           != np.asarray(stack_states(states)["population"]),
                           axis=(1, 2))
        states = new
    assert accepted.any(), "no step accepted a move"


def _gen():
    return generate_instance(30, 2, 5, seed=3, time_windowed=True,
                             device="cpu")


@pytest.mark.parametrize("name", ["TS", "LA", "SA", "SA-auto"])
def test_plain_solve_reports_plain_and_rescores(name):
    agent = {"TS": lambda: TabuSearch(16, 0.2, True, None, None, 4,
                                      StepsLimit(7)),
             "LA": lambda: LateAcceptance(10, 0.2, None, None, 4,
                                          StepsLimit(7)),
             "SA": lambda: SimulatedAnnealing(_T0, 0.9999, 0.2, None, None,
                                              4, StepsLimit(7)),
             "SA-auto": lambda: SimulatedAnnealing(_T0, None, 0.2, None,
                                                   None, 4, StepsLimit(7))
             }[name]()
    metrics = SolverMetrics()
    sol = Solver.solve(DomainBuilder.from_generator(_gen),
                       CotwinBuilder(False, True), agent, 3, seed=2,
                       logging_level=SolverLoggingLevels.Silent,
                       metrics=metrics)
    assert {r["kernel_path"] for r in metrics.records} == {"plain"}
    per_step = 16 if name == "TS" else 1
    assert metrics.records[0]["moves"] == 3 * 4 * per_step
    values = np.array([[v for _, v in sol[0]]], dtype=np.float32)
    req = ScoreRequester(CotwinBuilder(True, False).build_cotwin(_gen(),
                                                                 False))
    rescored = req.request_score_plain(torch.from_numpy(values))[0]
    assert rescored.tolist() == [sol[1]["hard_score"], sol[1]["medium_score"],
                                 sol[1]["soft_score"]]


def test_six_move_tabu_runs_the_f64_delta_path():
    agent = TabuSearch(16, 0.2, True, None, None, 4, StepsLimit(7))
    metrics = SolverMetrics()
    sol = Solver.solve(DomainBuilder.from_generator(_gen),
                       CotwinBuilder(True, True), agent, 2, seed=4,
                       logging_level=SolverLoggingLevels.Silent,
                       metrics=metrics)
    # kd = 16: the fused kernel's i32 rows do not serve it, and the step
    # scores f64 rows; the label is the JAX package's, which names the
    # registered int rows ("int-delta")
    assert {r["kernel_path"] for r in metrics.records} == {"int-delta"}
    req_d = ScoreRequester(CotwinBuilder(True, True).build_cotwin(_gen(),
                                                                  False))
    assert not req_d.delta_ints_eligible(16)
    values = np.array([[v for _, v in sol[0]]], dtype=np.float32)
    req = ScoreRequester(CotwinBuilder(True, False).build_cotwin(_gen(),
                                                                 False))
    assert req.request_score_plain(torch.from_numpy(values))[0].tolist() \
        == [sol[1]["hard_score"], sol[1]["medium_score"],
            sol[1]["soft_score"]]


def _nq_initial_conflicts(n):
    from greyjack_tpu_torch.models.nqueens import DomainBuilder as NQDomain
    return NQDomain(n, 45, device="cpu").build_domain_from_scratch(
    ).conflict_count()


@pytest.mark.parametrize("incremental", [True, False])
@pytest.mark.parametrize("name", ["LA", "SA", "SA-auto"])
def test_nqueens_local_search_improves(name, incremental):
    """Twins of `tests/test_metaheuristics.py:27-53` on N-Queens (swap
    moves only): LateAcceptance, SimulatedAnnealing with cooling and with
    the auto temperature improve on the shuffled board, on the delta
    cotwin (path "delta": a model with integer totals and no f64 ctx
    score) and on the plain one (path "plain"); the returned score is the
    returned board's conflict count."""
    from greyjack_tpu_torch.models.nqueens import (CotwinBuilder as NQCotwin,
                                                   DomainBuilder as NQDomain)

    swap = [0.0, 1.0, 0.0, 0.0, 0.0, 0.0]
    n, seed, agent = {
        "LA": (12, 2, lambda: LateAcceptance(16, 0.2, None, swap, 10,
                                             StepsLimit(200))),
        "SA": (12, 8, lambda: SimulatedAnnealing([1.0], 0.999, 0.0, None,
                                                 swap, 10, StepsLimit(200))),
        "SA-auto": (10, 9, lambda: SimulatedAnnealing(
            [1.0], None, 0.0, None, swap, 5, StepsLimit(60))),
    }[name]
    db = NQDomain(n, 45, device="cpu")
    metrics = SolverMetrics()
    sol = Solver.solve(db, NQCotwin(incremental), agent(), n_jobs=2,
                       logging_level=SolverLoggingLevels.Silent, seed=seed,
                       metrics=metrics)
    assert {r["kernel_path"] for r in metrics.records} == {
        "delta" if incremental else "plain"}
    final = sol[1]["simple_value"]
    if name == "SA-auto":
        assert final <= _nq_initial_conflicts(n)
    else:
        assert final < _nq_initial_conflicts(n)
    assert final == db.build_from_solution(sol).conflict_count()
