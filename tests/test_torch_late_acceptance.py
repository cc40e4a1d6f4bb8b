"""LateAcceptance in the torch port vs the JAX package: the ring buffer,
one delta step and one sweep step from a fixed JAX state (one island
inactive) with the JAX package's draws fed in, the runner's LateAcceptance
migration and adoption arms, and small `Solver.solve` runs whose returned
score must equal a plain rescore.

The JAX steps run eagerly (f64 rows divide by 1000.0 as the port does),
with their integer-only stages jitted (`jit_integer_stages`)."""

import warnings
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from greyjack_tpu.agents import LateAcceptance as JLateAcceptance
from greyjack_tpu.agents import base as jbase
from greyjack_tpu.agents import late_acceptance as jla
from greyjack_tpu.agents.termination_strategies import StepsLimit as JSteps
from greyjack_tpu.models.vrp import sweep as jsweep
from greyjack_tpu.ops import moves as jmoves
from greyjack_tpu.parallel import IslandRunner as JRunner

from _port_parity import (vrp_pair, to_np, assert_tree_equal,
                          jax_sweep_targets, tabu_state_to_port,
                          jit_integer_stages, step_keys, warm_jax_state)
from greyjack_tpu_torch.agents import LateAcceptance
from greyjack_tpu_torch.agents import base as tbase
from greyjack_tpu_torch.agents import late_acceptance as tla
from greyjack_tpu_torch.agents.termination_strategies import StepsLimit
from greyjack_tpu_torch.interop import from_numpy_tree
from greyjack_tpu_torch.models.vrp import (CotwinBuilder, DomainBuilder,
                                           generate_instance)
from greyjack_tpu_torch.models.vrp import sweep as tsweep
from greyjack_tpu_torch.ops import moves as tmoves
from greyjack_tpu_torch.parallel import IslandRunner as TRunner
from greyjack_tpu_torch.score_calculation.score_requesters import ScoreRequester
from greyjack_tpu_torch.solver import Solver, SolverLoggingLevels, SolverMetrics

torch.set_num_threads(1)

_PROBAS = [0.5, 0.5, 0, 0, 0, 0]
_TARGETS, _WINDOW = 12, 8
_N_ISL = 3
_ACTIVE = np.array([True, True, False])


@pytest.fixture(scope="module")
def warm():
    """The instance in both packages, JAX and port kernels of both forms
    (ring size 3, so the warm-up steps wrap it), and each JAX kernel's
    state after three warm-up steps."""
    mp = pytest.MonkeyPatch()
    mp.delenv("GJ_PALLAS_INTERPRET", raising=False)
    jreq, treq, _, _ = vrp_pair(True, n=30, d=2, kveh=5, seed=3, greedy=True)
    jit_integer_stages(mp, [jreq])
    out = {"jreq": jreq}
    for form, kw in (("delta", {}), ("sweep", dict(
            sweep=True, sweep_targets=_TARGETS, sweep_window=_WINDOW))):
        jk = JLateAcceptance(3, 0.2, None, _PROBAS, 2, JSteps(10),
                             **kw).build_kernel(jreq, None)
        tk = LateAcceptance(3, 0.2, None, _PROBAS, 2, StepsLimit(10),
                            **kw).build_kernel(treq, None)
        assert jk.path == tk.path == form
        assert jk.self_gating == tk.self_gating == (form == "sweep")
        out[form] = (jk, tk, warm_jax_state(jk, _N_ISL, 4, 3))
    yield out
    mp.undo()


def test_ring_ops_match_jax():
    rng = np.random.default_rng(0)
    size, s = 4, 3
    jring = jax.vmap(lambda _: jla.ring_init(size, s))(jnp.arange(_N_ISL))
    tring = tla.ring_init(_N_ISL, size, s, "cpu")
    assert_tree_equal(to_np(jring), tring, "init")
    for i in range(9):
        score = rng.integers(0, 5, size=(_N_ISL, s)).astype(np.float64)
        enable = rng.random(_N_ISL) < 0.7
        fallback = rng.integers(0, 5, size=(_N_ISL, s)).astype(np.float64)
        jold = jax.vmap(jla.ring_oldest)(jring, jnp.asarray(fallback))
        told = tla.ring_oldest(tring, torch.from_numpy(fallback))
        assert_tree_equal(to_np(jold), told, f"oldest {i}")
        jring = jax.vmap(jla.ring_push_front)(jring, jnp.asarray(score),
                                              jnp.asarray(enable))
        tring = tla.ring_push_front(tring, torch.from_numpy(score),
                                    torch.from_numpy(enable))
        assert_tree_equal(to_np(jring), tring, f"push {i}")
    # the ring wrapped: head - count is negative, a floor-mod slot
    assert (np.asarray(jring["count"]) == size).any()
    assert (np.asarray(jring["head"]) < np.asarray(jring["count"])).any()


def jax_sampler(monkeypatch, vm):
    """Run the JAX sampler jitted inside the eager step (it draws f32
    values, so the fed deltas must come from the same program) and return
    it: (k_move, base, tabu) -> (deltas, info) of one neighbour."""
    jcfg = jmoves.MoverConfig(vm, 0.2, None, _PROBAS)
    orig = jmoves.move_population_delta
    sample = jax.jit(lambda k, base, tabu: orig(k, base, 1, vm, jcfg, tabu))

    def patched(k, base, n, vm_, cfg, tabu, free=None):
        assert n == 1 and free is None
        return sample(k, base, tabu)

    monkeypatch.setattr(jmoves, "move_population_delta", patched)
    return sample


def test_delta_step_matches_jax(monkeypatch, warm):
    jk, tk, st = warm["delta"]
    sample = jax_sampler(monkeypatch, warm["jreq"].variables_manager)
    assert (np.asarray(st["late"]["count"]) > 0).all()
    keys = step_keys(9, 0, _N_ISL)
    fed = jax.vmap(lambda key, base, tabu: sample(
        jax.random.split(key)[0], base, tabu))(
        keys, st["population"][:, 0], st["tabu"])
    new = jbase.mask_state(jax.vmap(jk.step)(keys, st, {}), st,
                           jnp.asarray(_ACTIVE))

    tst = tabu_state_to_port(st)
    tfed = from_numpy_tree(to_np(fed), device="cpu")
    monkeypatch.setattr(tmoves, "move_population_delta", lambda *a, **k: tfed)
    tnew = tbase.mask_state(tk.step(None, tst, {}), tst,
                            torch.from_numpy(_ACTIVE))
    assert_tree_equal(to_np(new), tnew, "state")
    # the inactive island is its input, bit for bit
    assert_tree_equal(jax.tree.map(lambda x: np.asarray(x)[2], st),
                      jax.tree.map(lambda x: x[2], tnew), "inactive")
    pushed = np.asarray(new["late"]["head"]) != np.asarray(st["late"]["head"])
    assert pushed[:2].any() and not pushed[2]


def test_sweep_step_matches_jax(monkeypatch, warm):
    jk, tk, st = warm["sweep"]
    jsc = jsweep.SweepConfig(warm["jreq"], _TARGETS, _WINDOW)
    jcfg = jmoves.MoverConfig(warm["jreq"].variables_manager, 0.2, None,
                              _PROBAS)
    keys = step_keys(9, 1, _N_ISL)
    free = jcfg.tabu_free(st["tabu"])
    active = jnp.asarray(_ACTIVE)
    new = jax.vmap(jk.step)(keys, st, {"_free": free, "_active": active})

    tst = tabu_state_to_port(st)
    tfree = tk.prestep(tst)["_free"]
    assert_tree_equal(to_np(free), tfree, "free")
    rows = [jax_sweep_targets(keys[i], (free[0][i], free[1][i]),
                              st["ctx"]["base_over"][i], jsc)
            for i in range(_N_ISL)]
    targets = (torch.from_numpy(np.stack([r[0] for r in rows])),
               torch.from_numpy(np.stack([r[1] for r in rows])))
    monkeypatch.setattr(tsweep, "sample_targets", lambda *a, **k: targets)
    tnew = tk.step(None, tst, {"_free": tfree,
                               "_active": torch.from_numpy(_ACTIVE)})
    assert_tree_equal(to_np(new), tnew, "state")
    scored = np.asarray(new["sweep_scored"]) > np.asarray(st["sweep_scored"])
    np.testing.assert_array_equal(scored, _ACTIVE)


def _random_la_islands(rng, n_isl=6, v=10, size=3):
    # integer-valued rows with many ties, rings in every fill state
    count = rng.integers(0, size + 1, size=n_isl).astype(np.int32)
    return {
        "population": rng.integers(0, 9, size=(n_isl, 1, v)).astype(
            np.float32),
        "scores": rng.integers(0, 3, size=(n_isl, 1, 3)).astype(np.float64),
        "top_values": rng.integers(0, 9, size=(n_isl, v)).astype(np.float32),
        "top_score": rng.integers(0, 3, size=(n_isl, 3)).astype(np.float64),
        "late": {"buf": rng.integers(0, 3, size=(n_isl, size, 3)).astype(
                     np.float64),
                 "count": count,
                 "head": rng.integers(0, size, size=n_isl).astype(np.int32)},
    }


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_migrate_and_adopt_late_arms_match_jax(seed):
    rng = np.random.default_rng(seed)
    islands = _random_la_islands(rng)
    kern = SimpleNamespace(metaheuristic_kind="LocalSearch",
                           population_size=1, migration_rate=1.0,
                           refresh=None, prestep=None)
    jr = JRunner(kern, n_islands=6, migration_frequency=2)
    tr = TRunner(kern, n_islands=6, migration_frequency=2)
    state = {"global_values": rng.integers(0, 9, size=(10,)).astype(
        np.float32), "global_score": np.array([1.0, 0.0, 1.0])}
    jm = jr._migrate(jax.tree.map(jnp.asarray, islands),
                     roll_fn=lambda x: jnp.roll(x, 1, axis=0))
    tm = tr._migrate(from_numpy_tree(islands, device="cpu"))
    assert_tree_equal(to_np(jm), tm, "migrate")
    jg = jr._update_global({**jax.tree.map(jnp.asarray, state),
                            "islands": jm}, jm, gather_fn=None)
    tg = tr._update_global({**from_numpy_tree(state, device="cpu"),
                            "islands": tm}, tm)
    assert_tree_equal(to_np(jg), tg, "global")
    # both arms pushed into some ring and left others alone
    for before, after in ((islands, jm), (jm, jg["islands"])):
        moved = np.asarray(before["late"]["head"]) != np.asarray(
            after["late"]["head"])
        assert moved.any() and not moved.all()


def _gen(tw=True, span=100.0):
    return lambda: generate_instance(30, 2, 5, seed=3, time_windowed=tw,
                                     span=span, device="cpu")


def _solve(agent, gen, n_jobs=3):
    metrics = SolverMetrics()
    sol = Solver.solve(DomainBuilder.from_generator(gen),
                       CotwinBuilder(True, True), agent, n_jobs, seed=11,
                       logging_level=SolverLoggingLevels.Silent,
                       metrics=metrics)
    values = np.array([[v for _, v in sol[0]]], dtype=np.float32)
    req = ScoreRequester(CotwinBuilder(True, False).build_cotwin(gen(), False))
    rescored = req.request_score_plain(torch.from_numpy(values))[0]
    want = [sol[1]["hard_score"], sol[1]["medium_score"], sol[1]["soft_score"]]
    assert rescored.tolist() == want
    return metrics.records, want


@pytest.mark.parametrize("sweep", [True, False])
def test_solve_small_vrp(sweep):
    agent = LateAcceptance(20, 0.2, None, _PROBAS, 5, StepsLimit(19),
                           sweep=sweep, sweep_targets=_TARGETS,
                           sweep_window=_WINDOW)
    records, score = _solve(agent, _gen())
    # StepsLimit(19) with 5-step chunks: 20 steps -> 4 chunks
    assert len(records) == 4
    assert {r["kernel_path"] for r in records} == {
        "sweep" if sweep else "delta"}
    if sweep:
        assert records[0]["sweep_scored"] > 0
    # the greedy start is feasible; late acceptance never loses the best
    assert score[0] == 0.0


def test_ineligible_sweep_warns_and_runs_delta():
    agent = LateAcceptance(20, 0.2, None, _PROBAS, 5, StepsLimit(9),
                           sweep=True)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        records, _ = _solve(agent, _gen(span=20000.0), n_jobs=2)
    assert any(issubclass(w.category, RuntimeWarning)
               and "sweep=True" in str(w.message) for w in caught)
    assert {r["kernel_path"] for r in records} == {"delta"}
    assert "sweep_scored" not in records[0]
