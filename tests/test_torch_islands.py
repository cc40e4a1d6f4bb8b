"""One int-delta TabuSearch step and the island runner's migration /
global best of the torch port vs the JAX package, from fixed states.

The step is fed the neighbourhood the JAX sampler drew (the two packages'
random streams differ), so accept, chromosome, ctx, tabu ring and step
counter must come out equal."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from greyjack_tpu.agents import TabuSearch as JTabuSearch
from greyjack_tpu.agents.termination_strategies import StepsLimit as JSteps
from greyjack_tpu.ops import moves as jmoves
from greyjack_tpu.parallel import IslandRunner as JRunner

from _port_parity import vrp_pair, to_np, assert_leaf_equal, assert_tree_equal
from greyjack_tpu_torch.agents import TabuSearch as TTabuSearch
from greyjack_tpu_torch.agents.termination_strategies import StepsLimit
from greyjack_tpu_torch.interop import from_numpy_tree
from greyjack_tpu_torch.ops import moves as tmoves
from greyjack_tpu_torch.parallel import IslandRunner as TRunner

_PROBAS = [0.5, 0.5, 0, 0, 0, 0]
_N = 128


@pytest.fixture(autouse=True)
def _interp_env(monkeypatch):
    monkeypatch.setenv("GJ_PALLAS_INTERPRET", "1")


def test_tabu_step_matches_jax(monkeypatch):
    jreq, treq, _, _ = vrp_pair(True)
    jagent = JTabuSearch(_N, 0.2, True, None, _PROBAS, 2, JSteps(10))
    tagent = TTabuSearch(_N, 0.2, True, None, _PROBAS, 2, StepsLimit(10))
    jk = jagent.build_kernel(jreq, None)
    tk = tagent.build_kernel(treq, None)
    assert jk.path == tk.path == "int-delta"
    jcfg = jmoves.MoverConfig(jreq.variables_manager, 0.2, None, _PROBAS)
    vm = jreq.variables_manager

    n_isl = 3
    keys = jax.random.split(jax.random.key(4), n_isl)
    st = jax.vmap(jk.init_state)(keys)
    jstep = jax.vmap(jk.step)

    def sample(keys, st, free):
        def one(key, base, tabu, fl, cnt):
            k_move, _ = jax.random.split(key)
            return jmoves.move_population_delta(k_move, base, _N, vm, jcfg,
                                                tabu, (fl, cnt))
        return jax.vmap(one)(keys, st["population"][:, 0], st["tabu"],
                             free[0], free[1])

    active = jnp.array([True, True, False])
    # the JAX side runs eagerly: under jit XLA turns the score's `/ 1000.0`
    # into a multiply by 0.001 (last-bit differences), while the port
    # divides, as the eager reference does. Two warm-up steps fill the tabu
    # rings and move the ctx; the third is compared.
    for i in range(3):
        keys = jax.random.split(jax.random.fold_in(jax.random.key(9), i),
                                n_isl)
        free = jcfg.tabu_free(st["tabu"])
        if i < 2:
            st = jstep(keys, st, {"_free": free, "_active": active})
            continue
        deltas, info = sample(keys, st, free)
        new = jstep(keys, st, {"_free": free, "_active": active})

    tst = from_numpy_tree(to_np(st))
    tfree = tk.prestep(tst)["_free"]
    assert_tree_equal(to_np(free), tfree, "free")
    fed = (from_numpy_tree(to_np(deltas)), from_numpy_tree(to_np(info)))
    monkeypatch.setattr(tmoves, "move_population_delta", lambda *a, **k: fed)
    tnew = tk.step(None, tst, {"_free": tfree,
                               "_active": torch.tensor([True, True, False])})
    assert_tree_equal(to_np(new), tnew, "state")
    moved = ~np.all(np.asarray(new["ctx"]["r_stop"])
                    == np.asarray(st["ctx"]["r_stop"]), axis=(1, 2))
    assert moved[:2].any() and not moved[2]


def _random_islands(rng, n_isl=6, v=10):
    # integer-valued rows with many ties, one shared best
    scores = rng.integers(0, 3, size=(n_isl, 1, 3)).astype(np.float64)
    pop = rng.integers(0, 9, size=(n_isl, 1, v)).astype(np.float32)
    tops = rng.integers(0, 3, size=(n_isl, 3)).astype(np.float64)
    return {"population": pop, "scores": scores,
            "top_values": rng.integers(0, 9, size=(n_isl, v)).astype(
                np.float32),
            "top_score": tops}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_migrate_and_global_best_match_jax(seed):
    rng = np.random.default_rng(seed)
    islands = _random_islands(rng)
    kern = SimpleNamespace(metaheuristic_kind="LocalSearch",
                           population_size=1, migration_rate=1.0,
                           refresh=None, prestep=None)
    jr = JRunner(kern, n_islands=6, migration_frequency=2)
    tr = TRunner(kern, n_islands=6, migration_frequency=2)
    state = {"global_values": rng.integers(0, 9, size=(10,)).astype(
        np.float32), "global_score": np.array([1.0, 1.0, 1.0])}
    jm = jr._migrate(jax.tree.map(jnp.asarray, islands),
                     roll_fn=lambda x: jnp.roll(x, 1, axis=0))
    tm = tr._migrate(from_numpy_tree(islands))
    assert_tree_equal(to_np(jm), tm, "migrate")
    jg = jr._update_global({**jax.tree.map(jnp.asarray, state),
                            "islands": jm}, jm, gather_fn=None)
    tg = tr._update_global({**from_numpy_tree(state), "islands": tm}, tm)
    assert_tree_equal(to_np(jg), tg, "global")
