"""SimulatedAnnealing in the torch port vs the JAX package: one delta step
and one sweep step from a fixed JAX state (one island inactive), with
geometric cooling and with the auto-temperature extras, fed the JAX
package's draws (moves or sweep targets, and each island's accept
uniform); and small `Solver.solve` runs whose returned score must equal a
plain rescore.

`exp` is not bit-portable between XLA and torch, so the Metropolis
probabilities are held within 4 ulp, the accept flags exactly, and the
test checks that every deciding draw lies more than 4 ulp from its
probability. Everything else — score rows, temperatures, ctx, ring-free
state — is bit- and dtype-equal. The JAX steps run eagerly with their
integer-only stages jitted (`jit_integer_stages`)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from greyjack_tpu.agents import SimulatedAnnealing as JSimulatedAnnealing
from greyjack_tpu.agents import base as jbase
from greyjack_tpu.agents.termination_strategies import StepsLimit as JSteps
from greyjack_tpu.models.vrp import sweep as jsweep
from greyjack_tpu.ops import lexico as jlex
from greyjack_tpu.ops import moves as jmoves

from _port_parity import (vrp_pair, to_np, assert_leaf_equal,
                          assert_tree_equal, jax_sweep_targets,
                          tabu_state_to_port, jit_integer_stages, step_keys,
                          warm_jax_state)
from greyjack_tpu_torch.agents import SimulatedAnnealing
from greyjack_tpu_torch.agents import base as tbase
from greyjack_tpu_torch.agents import simulated_annealing as tsa
from greyjack_tpu_torch.agents.termination_strategies import StepsLimit
from greyjack_tpu_torch.interop import from_numpy_tree
from greyjack_tpu_torch.models.vrp import (CotwinBuilder, DomainBuilder,
                                           generate_instance)
from greyjack_tpu_torch.models.vrp import sweep as tsweep
from greyjack_tpu_torch.ops import lexico as tlex
from greyjack_tpu_torch.ops import moves as tmoves
from greyjack_tpu_torch.score_calculation.score_requesters import ScoreRequester
from greyjack_tpu_torch.solver import Solver, SolverLoggingLevels, SolverMetrics

torch.set_num_threads(1)

_PROBAS = [0.5, 0.5, 0, 0, 0, 0]
_TARGETS, _WINDOW = 12, 8
_N_ISL = 3
_ACTIVE = np.array([True, True, False])
_T0 = [1000.0, 1000.0, 1.0]
# temperatures set into the compared state: worse candidates then pass
# with probabilities well inside (0, 1)
_T_STEP = np.array([[2e4, 2e4, 8.0], [5e3, 5e3, 3.0], [2e4, 2e4, 8.0]])
_RATE = np.array([0.8, 0.3, 0.5])


@pytest.fixture(scope="module")
def warm():
    """The instance in both packages and, per (form, cooling), JAX and
    port kernels and the JAX state after three warm-up steps."""
    mp = pytest.MonkeyPatch()
    mp.delenv("GJ_PALLAS_INTERPRET", raising=False)
    jreq, treq, _, _ = vrp_pair(True, n=30, d=2, kveh=5, seed=3, greedy=True)
    jit_integer_stages(mp, [jreq])
    out = {"jreq": jreq, "treq": treq}
    for form in ("delta", "sweep"):
        kw = ({} if form == "delta" else
              dict(sweep=True, sweep_targets=_TARGETS, sweep_window=_WINDOW))
        for cooling in (0.9, None):
            jk = JSimulatedAnnealing(_T0, cooling, 0.2, None, _PROBAS, 2,
                                     JSteps(10), **kw).build_kernel(jreq)
            tk = SimulatedAnnealing(_T0, cooling, 0.2, None, _PROBAS, 2,
                                    StepsLimit(10), **kw).build_kernel(treq)
            assert jk.path == tk.path == form
            assert jk.self_gating == tk.self_gating == (form == "sweep")
            extras = ({} if cooling is not None else
                      {"inverted_accomplish_rate": jnp.asarray(_RATE)})
            st = warm_jax_state(jk, _N_ISL, 4, 3, extras)
            st = {**st, "temperature": jnp.asarray(_T_STEP)}
            out[form, cooling] = (jk, tk, st, extras)
    yield out
    mp.undo()


def _assert_within_ulps(a, b, n):
    """Non-negative f64 arrays equal within `n` ulp; inf, nan (an inf
    factor times a zero one) and zero must match exactly."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    fin = np.isfinite(a)
    np.testing.assert_array_equal(a[~fin & ~np.isnan(a)],
                                  b[~fin & ~np.isnan(b)])
    assert (a[fin] >= 0).all() and (b[fin] >= 0).all()
    ulps = np.abs(a[fin].view(np.int64) - b[fin].view(np.int64))
    assert (ulps <= n).all(), (a, b)


def _check_acceptance(cand_j, cur, temp, u, tcand, ttemp):
    """The Metropolis decision of both packages on one step's candidates:
    JAX's formula (`simulated_annealing.py`) eagerly against the port's
    `accept_proba`, draws away from the boundary, flags equal."""
    assert_leaf_equal(cand_j, tcand, "candidate rows")
    assert_leaf_equal(temp, ttemp, "temperature")
    d = jnp.asarray(cand_j) - jnp.asarray(cur)
    pj = np.asarray(jnp.prod(jnp.exp(-(d / jnp.asarray(temp))), axis=-1))
    pt = tsa.accept_proba(tcand, torch.tensor(cur), ttemp).numpy()
    _assert_within_ulps(pj, pt, 4)
    better_j = np.asarray(jax.vmap(jlex.lex_leq)(jnp.asarray(cand_j),
                                                 jnp.asarray(cur)))
    better_t = tlex.lex_leq(tcand, torch.tensor(cur)).numpy()
    np.testing.assert_array_equal(better_j, better_t)
    # every draw that decides lies more than 4 ulp from its probability
    # (a nan probability accepts nothing, in both packages)
    deciding = ~better_j & ~np.isnan(pj)
    gap = np.abs(u - pj) / np.spacing(np.maximum(pj, 1e-300))
    assert (gap[deciding] > 4).all(), (u, pj)
    flags_j = better_j | (u < pj)
    flags_t = better_t | (u < pt)
    np.testing.assert_array_equal(flags_j, flags_t)
    return flags_j, deciding


def _feed_u(monkeypatch, u):
    monkeypatch.setattr(tsa, "accept_uniforms",
                        lambda gens, dev: torch.tensor(u))


def _accept_draws(keys):
    return np.asarray(jax.vmap(lambda k: jax.random.uniform(
        jax.random.split(k)[1], (), dtype=jnp.float64))(keys))


@pytest.mark.parametrize("cooling", [0.9, None])
def test_delta_step_matches_jax(monkeypatch, warm, cooling):
    jk, tk, st, extras = warm["delta", cooling]
    jreq, treq = warm["jreq"], warm["treq"]
    vm = jreq.variables_manager
    jcfg = jmoves.MoverConfig(vm, 0.2, None, _PROBAS)
    orig = jmoves.move_population_delta
    sample = jax.jit(lambda k, base, tabu: orig(k, base, 1, vm, jcfg, tabu))
    monkeypatch.setattr(jmoves, "move_population_delta",
                        lambda k, base, n, vm_, cfg, tabu, free=None:
                        sample(k, base, tabu))
    keys = step_keys(9, 0, _N_ISL)
    fed = jax.vmap(lambda key, base, tabu: sample(
        jax.random.split(key)[0], base, tabu))(
        keys, st["population"][:, 0], st["tabu"])
    new = jbase.mask_state(jax.vmap(jk.step)(keys, st, extras), st,
                           jnp.asarray(_ACTIVE))

    tst = tabu_state_to_port(st)
    tfed = from_numpy_tree(to_np(fed), device="cpu")
    u = _accept_draws(keys)
    monkeypatch.setattr(tmoves, "move_population_delta", lambda *a, **k: tfed)
    _feed_u(monkeypatch, u)
    tex = from_numpy_tree(to_np(extras), device="cpu")
    traw = tk.step(None, tst, tex)
    tnew = tbase.mask_state(traw, tst, torch.from_numpy(_ACTIVE))
    assert_tree_equal(to_np(new), tnew, "state")

    # the decision itself: candidate rows through JAX's vmap(score_delta)
    # and the port's fused-kernel route
    cand_j = np.stack([np.asarray(jreq.request_score_delta(
        jax.tree.map(lambda x: x[i], st["ctx"]),
        jax.tree.map(lambda x: x[i], fed[0])))[0] for i in range(_N_ISL)])
    tcand = treq.request_score_delta(tst["ctx"], tfed[0])[:, 0]
    cur = np.asarray(st["scores"])[:, 0]
    if cooling is not None:
        temp = np.asarray(st["temperature"]) * cooling
        temp = np.where(temp < 1e-6, 1e-7, temp)
    else:
        temp = np.broadcast_to(_RATE[:, None], (_N_ISL, 3))
    flags, deciding = _check_acceptance(cand_j, cur, temp, u, tcand,
                                        traw["temperature"])
    # some island's decision rests on its draw
    assert deciding.any(), flags


@pytest.mark.parametrize("cooling", [0.9, None])
def test_sweep_step_matches_jax(monkeypatch, warm, cooling):
    jk, tk, st, extras = warm["sweep", cooling]
    jreq = warm["jreq"]
    jsc = jsweep.SweepConfig(jreq, _TARGETS, _WINDOW)
    jcfg = jmoves.MoverConfig(jreq.variables_manager, 0.2, None, _PROBAS)
    keys = step_keys(9, 1, _N_ISL)
    free = jcfg.tabu_free(st["tabu"])
    active = jnp.asarray(_ACTIVE)
    new = jax.vmap(jk.step)(keys, st, {**extras, "_free": free,
                                       "_active": active})

    tst = tabu_state_to_port(st)
    tfree = tk.prestep(tst)["_free"]
    rows = [jax_sweep_targets(jax.random.split(keys[i])[0],
                              (free[0][i], free[1][i]),
                              st["ctx"]["base_over"][i], jsc)
            for i in range(_N_ISL)]
    targets = (torch.from_numpy(np.stack([r[0] for r in rows])),
               torch.from_numpy(np.stack([r[1] for r in rows])))
    monkeypatch.setattr(tsweep, "sample_targets", lambda *a, **k: targets)
    u = _accept_draws(keys)
    _feed_u(monkeypatch, u)
    tex = {**from_numpy_tree(to_np(extras), device="cpu"), "_free": tfree,
           "_active": torch.from_numpy(_ACTIVE)}
    tnew = tk.step(None, tst, tex)
    assert_tree_equal(to_np(new), tnew, "state")
    # inactive: the temperature holds; active: it cooled or took the rate
    np.testing.assert_array_equal(np.asarray(new["temperature"])[2],
                                  _T_STEP[2])
    assert (np.asarray(new["temperature"])[:2] != _T_STEP[:2]).all()

    # the decision on the sweep winner's exact row
    uj, ut = jreq._delta_utils(), warm["treq"]._delta_utils()
    jprop = jax.vmap(lambda k, c, fl, fc, tb: jsweep.propose(
        jax.random.split(k)[0], c, (fl, fc), jcfg.tabu_masks(tb), jsc, uj))(
        keys, st["ctx"], free[0], free[1], st["tabu"])
    cand_j = np.stack([np.asarray(jsweep.exact_score_row(
        jax.tree.map(lambda x: x[i], st["ctx"]), jprop[1][i], uj))
        for i in range(_N_ISL)])
    tcfg = tmoves.MoverConfig(warm["treq"].variables_manager, 0.2, None,
                              _PROBAS)
    tprop = tsweep.propose(None, tst["ctx"], tfree,
                           tcfg.tabu_masks(tst["tabu"]),
                           tsweep.SweepConfig(warm["treq"], _TARGETS,
                                              _WINDOW), ut)
    assert_tree_equal(to_np(jprop), tprop, "proposal")
    tcand = tsweep.exact_score_row(tst["ctx"], tprop[1], ut)
    _check_acceptance(cand_j, np.asarray(st["scores"])[:, 0],
                      np.asarray(new["temperature"]), u, tcand,
                      tnew["temperature"])


def _gen(tw=True):
    return lambda: generate_instance(30, 2, 5, seed=3, time_windowed=tw,
                                     device="cpu")


@pytest.mark.parametrize("sweep,cooling", [(True, 0.9999), (False, 0.9999),
                                           (False, None), (True, None)])
def test_solve_small_vrp(sweep, cooling):
    agent = SimulatedAnnealing(_T0, cooling, 0.2, None, _PROBAS, 5,
                               StepsLimit(19), sweep=sweep,
                               sweep_targets=_TARGETS, sweep_window=_WINDOW)
    metrics = SolverMetrics()
    gen = _gen()
    sol = Solver.solve(DomainBuilder.from_generator(gen),
                       CotwinBuilder(True, True), agent, 3, seed=11,
                       logging_level=SolverLoggingLevels.Silent,
                       metrics=metrics)
    # StepsLimit(19) with 5-step chunks: 20 steps -> 4 chunks
    assert len(metrics.records) == 4
    assert {r["kernel_path"] for r in metrics.records} == {
        "sweep" if sweep else "delta"}
    values = np.array([[v for _, v in sol[0]]], dtype=np.float32)
    req = ScoreRequester(CotwinBuilder(True, False).build_cotwin(gen(), False))
    rescored = req.request_score_plain(torch.from_numpy(values))[0]
    want = [sol[1]["hard_score"], sol[1]["medium_score"], sol[1]["soft_score"]]
    assert rescored.tolist() == want


def test_auto_temperature_follows_the_accomplish_rate(monkeypatch):
    """cooling_rate=None: the solver hands the runner each island's
    1 - accomplish rate at the chunk's start and end, and the step sees
    the per-step lerp (StepsLimit(9), 5-step chunks: steps 0..9 of 9)."""
    seen = []
    orig = tsa.accept_proba

    def spy(cand, current, temp):
        seen.append(temp[:, 0].clone())
        return orig(cand, current, temp)

    monkeypatch.setattr(tsa, "accept_proba", spy)
    agent = SimulatedAnnealing(_T0, None, 0.2, None, _PROBAS, 5,
                               StepsLimit(9))
    Solver.solve(DomainBuilder.from_generator(_gen()),
                 CotwinBuilder(True, True), agent, 2, seed=3,
                 logging_level=SolverLoggingLevels.Silent)
    temps = torch.stack(seen)
    assert temps.shape == (10, 2)
    want = torch.tensor([1.0 - i / 9.0 for i in range(10)],
                        dtype=torch.float64)
    torch.testing.assert_close(temps[:, 0], want, rtol=0, atol=1e-15)
    assert torch.equal(temps[:, 0], temps[:, 1])
