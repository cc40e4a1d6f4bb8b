"""GeneticAlgorithm and the runner's Population arm, torch port vs the JAX
package.

The GA step's deterministic body, fed the leaves the JAX step draws from
the same key (p-best / p-worst pairs, crossover weight and coin, the
children's move noise), gives the JAX step's state bit for bit: sorted
population, f64 score rows, island best. The Population `_migrate` (top-k
migrants against the ring successor's worst, re-sort) and `_update_global`
(no adoption) equal the JAX runner's. Tolerance: none. A small
`Solver.solve` reports path "plain", P moves an island-step, and a score
equal to a plain rescore."""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from greyjack_tpu.agents import GeneticAlgorithm as JGA
from greyjack_tpu.agents.termination_strategies import StepsLimit as JSteps
from greyjack_tpu.ops import moves as jmoves
from greyjack_tpu.parallel.islands import IslandRunner as JRunner

from _port_parity import (plain_pair, vrp_pair, stack_states,
                          assert_tree_equal, jax_move_noise,
                          jax_population_noise)
from greyjack_tpu_torch.agents import GeneticAlgorithm
from greyjack_tpu_torch.agents.genetic_algorithm import (p_best_ids,
                                                         p_worst_ids)
from greyjack_tpu_torch.agents.termination_strategies import StepsLimit
from greyjack_tpu_torch.interop import from_numpy_tree
from greyjack_tpu_torch.models.vrp import (CotwinBuilder, DomainBuilder,
                                           generate_instance)
from greyjack_tpu_torch.parallel import IslandRunner
from greyjack_tpu_torch.score_calculation.score_requesters import (
    ScoreRequester)
from greyjack_tpu_torch.solver import Solver, SolverLoggingLevels, SolverMetrics

_N_ISL = 3


def _ga(pkg, p, probas, mult=None, rate=0.3):
    args = (p, 0.5, 0.3, 0.2, mult, probas, rate, 4)
    if pkg == "jax":
        return JGA(*args, JSteps(5))
    return GeneticAlgorithm(*args, StepsLimit(5))


def _jax_leaves(key, jk_p, half, cross_proba, p_best_rate, jvm, jcfg, dtype):
    """The leaves the JAX GA step draws from `key`
    (`greyjack_tpu/agents/genetic_algorithm.py:54-105`)."""
    ks = jax.random.split(key, 6)

    def pair(k, count):
        k1, k2 = jax.random.split(k)
        proba = jax.random.uniform(k1, (count,), jnp.float64, minval=1e-6,
                                   maxval=p_best_rate)
        return proba, jax.random.uniform(k2, (count,), jnp.float64)

    w = jax.random.uniform(ks[2], (half, 1), dtype)
    cross = jax.random.uniform(ks[3], (half, 1), jnp.float64) <= cross_proba
    return {"best_1": pair(ks[0], half), "best_2": pair(ks[1], half),
            "w": w, "cross": cross, "worst": pair(ks[5], jk_p)}, ks[4]


@pytest.fixture(scope="module")
def pair():
    return plain_pair()


@pytest.mark.parametrize("p,probas,mult", [
    (8, [0.5, 0.5, 0, 0, 0, 0], None),
    (7, None, None),
    (6, None, 1.0)])
def test_ga_step_bit_equal(pair, p, probas, mult):
    jreq, treq = pair
    jk = _ga("jax", p, probas, mult).build_kernel(jreq)
    tk = _ga("torch", p, probas, mult).build_kernel(treq)
    assert jk.path == tk.path == "plain" and tk.moves_per_step == p
    jvm = jreq.variables_manager
    jcfg = jmoves.MoverConfig(jvm, 0.2, mult, probas)
    half = -(-p // 2)
    states = [jk.init_state(k)
              for k in jax.random.split(jax.random.key(1), _N_ISL)]
    tstate = from_numpy_tree(stack_states(states), device="cpu")
    replaced = False
    for step in range(3):
        keys = jax.random.split(jax.random.fold_in(jax.random.key(2), step),
                                _N_ISL)
        new = [jk.step(keys[i], states[i], {}) for i in range(_N_ISL)]
        drawn = [_jax_leaves(k, p, half, 0.5, 0.3, jvm, jcfg, jnp.float32)
                 for k in keys]
        leaves = from_numpy_tree(stack_states([d for d, _ in drawn]),
                                 device="cpu")
        leaves["best_1"] = tuple(leaves["best_1"])
        leaves["best_2"] = tuple(leaves["best_2"])
        leaves["worst"] = tuple(leaves["worst"])
        leaves["move"] = jax_population_noise([k for _, k in drawn],
                                              jax_move_noise, jvm, jcfg,
                                              jnp.float32, 2 * half)
        tstate = tk.body(tstate, leaves)
        assert_tree_equal(stack_states(new), tstate, f"step {step}")
        replaced |= bool(np.any(np.asarray(stack_states(new)["scores"])
                                != np.asarray(stack_states(states)["scores"])))
        states = new
    assert replaced, "no candidate replaced a native"


def test_selection_ids_in_range():
    proba = torch.tensor([1e-6, 0.05, 0.3, 0.3], dtype=torch.float64)
    u = torch.tensor([0.0, 0.999, 0.5, 0.999], dtype=torch.float64)
    best = p_best_ids(proba, u, 10)
    worst = p_worst_ids(proba, u, 10)
    assert best.tolist() == [0, 0, 1, 2]
    assert worst.tolist() == [9, 9, 8, 9]


def test_ga_draw_leaves(pair):
    _, treq = pair
    tk = _ga("torch", 9, None).build_kernel(treq)
    gens = [torch.Generator().manual_seed(i) for i in range(2)]
    leaves = tk.draw(gens)
    half = 5
    assert leaves["w"].shape == (2, half, 1)
    assert leaves["w"].dtype == torch.float32
    assert leaves["cross"].dtype == torch.bool
    for name in ("best_1", "best_2", "worst"):
        proba, u = leaves[name]
        assert (proba >= 1e-6).all() and (proba < 0.3).all()
        assert (u >= 0).all() and (u < 1).all()
    assert leaves["worst"][0].shape == (2, 9)
    assert leaves["move"]["gumbel"].shape[:2] == (2, 2 * half)


@pytest.mark.parametrize("rate", [0.3, 0.6])
def test_population_migration_and_global_bit_equal(pair, rate):
    jreq, treq = pair
    p = 6
    jk = _ga("jax", p, None, rate=rate).build_kernel(jreq)
    tk = _ga("torch", p, None, rate=rate).build_kernel(treq)
    jr = JRunner(jk, _N_ISL, 4)
    tr = IslandRunner(tk, _N_ISL, 4, compare_to_global=True)
    assert tr.migrants_count == jr.migrants_count == max(
        1, math.ceil(rate * p))
    jstate = jr.init(jax.random.key(4))
    # advance a few eager steps so islands differ in quality
    islands = jstate["islands"]
    for s in range(2):
        keys = jax.random.split(jax.random.key(10 + s), _N_ISL)
        islands = jax.vmap(jk.step)(keys, islands, {})
    t_islands = from_numpy_tree(jax.tree.map(np.asarray, islands),
                                device="cpu")
    jm = jr._migrate(islands, roll_fn=lambda x: jnp.roll(x, 1, axis=0))
    tm = tr._migrate(t_islands)
    assert_tree_equal(jax.tree.map(np.asarray, jm), tm, "migrate")
    assert np.any(np.asarray(jm["scores"]) != np.asarray(islands["scores"]))
    jstate = {**jstate, "islands": islands}
    tstate = from_numpy_tree(jax.tree.map(np.asarray, jstate), device="cpu")
    jg = jr._update_global(jstate, jm, gather_fn=None)
    tg = tr._update_global(tstate, tm)
    assert_tree_equal(jax.tree.map(np.asarray, jg), tg, "global")
    # Population islands never adopt the global best
    assert_tree_equal(jax.tree.map(np.asarray, jm), tg["islands"],
                      "no adoption")


def _gen():
    return generate_instance(30, 2, 5, seed=3, time_windowed=True,
                             device="cpu")


@pytest.mark.parametrize("delta_cotwin", [True, False])
def test_ga_solve_reports_plain_and_rescores(delta_cotwin):
    agent = GeneticAlgorithm(10, 0.5, 0.05, 0.2, None,
                             [0.5, 0.5, 0, 0, 0, 0], 0.1, 4, StepsLimit(9))
    metrics = SolverMetrics()
    sol = Solver.solve(DomainBuilder.from_generator(_gen),
                       CotwinBuilder(delta_cotwin, True), agent, 2, seed=6,
                       logging_level=SolverLoggingLevels.Silent,
                       metrics=metrics)
    assert {r["kernel_path"] for r in metrics.records} == {"plain"}
    assert metrics.records[0]["moves"] == 2 * 4 * 10
    values = np.array([[v for _, v in sol[0]]], dtype=np.float32)
    req = ScoreRequester(CotwinBuilder(True, False).build_cotwin(_gen(),
                                                                 False))
    rescored = req.request_score_plain(torch.from_numpy(values))[0]
    assert rescored.tolist() == [sol[1]["hard_score"], sol[1]["medium_score"],
                                 sol[1]["soft_score"]]
