"""The sweep TabuSearch kernel of the torch port vs the JAX package, and the
sweep path end to end through `Solver.solve` on the CPU.

One step from a fixed JAX state is fed the target rows the JAX step drew
from its key (the two packages' random streams differ), so the winner,
accept (including the stall-escape forced accept), chromosome, ctx, tabu
ring and the sweep counters must come out equal."""

import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from greyjack_tpu.agents import TabuSearch as JTabuSearch
from greyjack_tpu.agents.termination_strategies import StepsLimit as JSteps
from greyjack_tpu.models.vrp import CotwinBuilder as JCotwinBuilder
from greyjack_tpu.models.vrp import generate_instance as j_generate
from greyjack_tpu.models.vrp import sweep as jsweep
from greyjack_tpu.ops import moves as jmoves
from greyjack_tpu.score_calculation.score_requesters import (
    ScoreRequester as JScoreRequester,
)

from _port_parity import (vrp_pair, to_np, assert_tree_equal,
                          jax_sweep_targets, tabu_state_to_port)
from greyjack_tpu_torch.agents import TabuSearch
from greyjack_tpu_torch.agents.termination_strategies import StepsLimit
from greyjack_tpu_torch.models.vrp import (CotwinBuilder, DomainBuilder,
                                           generate_instance)
from greyjack_tpu_torch.models.vrp import sweep as tsweep
from greyjack_tpu_torch.score_calculation.score_requesters import ScoreRequester
from greyjack_tpu_torch.solver import Solver, SolverLoggingLevels, SolverMetrics

torch.set_num_threads(1)

_PROBAS = [0.5, 0.5, 0, 0, 0, 0]
_TARGETS, _WINDOW, _STALL = 12, 8, 32


@pytest.fixture(scope="module")
def warm():
    """Both kernels and a JAX state of 3 islands after two eager warm-up
    steps (they fill the tabu rings and move the ctx)."""
    jreq, treq, _, _ = vrp_pair(True, n=30, d=2, kveh=5, seed=3, greedy=True)
    args = (64, 0.2, True, None, _PROBAS, 2)
    kw = dict(sweep=True, sweep_targets=_TARGETS, sweep_window=_WINDOW,
              sweep_stall_limit=_STALL)
    jk = JTabuSearch(*args, JSteps(10), **kw).build_kernel(jreq, None)
    tk = TabuSearch(*args, StepsLimit(10), **kw).build_kernel(treq, None)
    jcfg = jmoves.MoverConfig(jreq.variables_manager, 0.2, None, _PROBAS)
    st = jax.vmap(jk.init_state)(jax.random.split(jax.random.key(4), 3))
    for i in range(2):
        st = jax.vmap(jk.step)(_keys(i), st, {
            "_free": jcfg.tabu_free(st["tabu"]), "_active": _ACTIVE})
    return jreq, jk, tk, jcfg, st


_ACTIVE = jnp.array([True, True, False])


def _keys(i):
    return jax.random.split(jax.random.fold_in(jax.random.key(9), i), 3)


@pytest.mark.parametrize("stall", [0, _STALL])
def test_sweep_step_matches_jax(monkeypatch, warm, stall):
    jreq, jk, tk, jcfg, st = warm
    assert jk.path == tk.path == "sweep"
    assert jk.moves_per_step == tk.moves_per_step
    jsc = jsweep.SweepConfig(jreq, _TARGETS, _WINDOW)
    n_isl = 3
    # eager JAX: f64 score rows as the port computes them
    keys = _keys(2)
    free = jcfg.tabu_free(st["tabu"])
    st = {**st, "sweep_stall": jnp.full((n_isl,), stall, jnp.int32)}
    new = jax.vmap(jk.step)(keys, st, {"_free": free, "_active": _ACTIVE})

    tst = tabu_state_to_port(st)
    tfree = tk.prestep(tst)["_free"]
    assert_tree_equal(to_np(free), tfree, "free")
    rows = [jax_sweep_targets(keys[i], (free[0][i], free[1][i]),
                              st["ctx"]["base_over"][i], jsc)
            for i in range(n_isl)]
    targets = (torch.from_numpy(np.stack([r[0] for r in rows])),
               torch.from_numpy(np.stack([r[1] for r in rows])))
    monkeypatch.setattr(tsweep, "sample_targets", lambda *a, **k: targets)
    tnew = tk.step(None, tst, {"_free": tfree,
                               "_active": torch.tensor([True, True, False])})
    assert_tree_equal(to_np(new), tnew, "state")

    moved = np.any(np.asarray(new["population"])
                   != np.asarray(st["population"]), axis=(1, 2))
    assert not moved[2]
    if stall == _STALL:
        # forced accept: every active island takes its best candidate
        assert moved[:2].all()
    np.testing.assert_array_equal(
        np.asarray(new["sweep_scored"]) > np.asarray(st["sweep_scored"]),
        [True, True, False])


@pytest.mark.parametrize("tw", [True, False])
def test_solve_small_vrp_sweep_path(tw):
    def gen():
        return generate_instance(30, 2, 5, seed=3, time_windowed=tw,
                                 device="cpu")

    agent = TabuSearch(64, 0.2, True, None, _PROBAS, 5, StepsLimit(19),
                       sweep=True, sweep_targets=_TARGETS,
                       sweep_window=_WINDOW)
    metrics = SolverMetrics()
    sol = Solver.solve(DomainBuilder.from_generator(gen),
                       CotwinBuilder(True, True), agent, 2, seed=11,
                       logging_level=SolverLoggingLevels.Silent,
                       metrics=metrics)
    assert {r["kernel_path"] for r in metrics.records} == {"sweep"}
    # StepsLimit(19) with 5-step chunks: 20 steps -> 4 chunks
    assert len(metrics.records) == 4
    scored = [r["sweep_scored"] for r in metrics.records]
    assert scored[0] > 0 and scored == sorted(scored)
    assert 0 <= metrics.records[-1]["sweep_nonconv"] <= scored[-1]
    values = np.array([[v for _, v in sol[0]]], dtype=np.float32)
    req = ScoreRequester(CotwinBuilder(True, False).build_cotwin(gen(), False))
    rescored = req.request_score_plain(torch.from_numpy(values))[0]
    want = [sol[1]["hard_score"], sol[1]["medium_score"], sol[1]["soft_score"]]
    assert rescored.tolist() == want
    assert want[0] == 0.0


def _late_window(domain):
    # one time window past the sweep's i32 time bound (t_max < 2^22)
    domain.customers_vec[5].time_window_start = 1 << 22
    return domain


def test_ineligible_sweep_warns_and_runs_int_delta():
    def gen():
        return _late_window(generate_instance(30, 2, 5, seed=3,
                                              time_windowed=True,
                                              device="cpu"))

    jreq = JScoreRequester(JCotwinBuilder(True, True).build_cotwin(
        _late_window(j_generate(30, 2, 5, seed=3, time_windowed=True)),
        False))
    assert not jreq.supports_sweep
    agent = TabuSearch(64, 0.2, True, None, _PROBAS, 5, StepsLimit(9),
                       sweep=True)
    metrics = SolverMetrics()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        sol = Solver.solve(DomainBuilder.from_generator(gen),
                           CotwinBuilder(True, True), agent, 2, seed=5,
                           logging_level=SolverLoggingLevels.Silent,
                           metrics=metrics)
    assert any(issubclass(w.category, RuntimeWarning)
               and "sweep=True" in str(w.message) for w in caught)
    assert {r["kernel_path"] for r in metrics.records} == {"int-delta"}
    assert "sweep_scored" not in metrics.records[0]
    values = np.array([[v for _, v in sol[0]]], dtype=np.float32)
    req = ScoreRequester(CotwinBuilder(True, False).build_cotwin(gen(), False))
    rescored = req.request_score_plain(torch.from_numpy(values))[0]
    assert rescored.tolist() == [sol[1]["hard_score"],
                                 sol[1]["medium_score"],
                                 sol[1]["soft_score"]]
