"""The island runner's per-step arms in the torch port vs the JAX package:
`mask_state` for kernels that do not gate themselves (an inactive island
comes out bit-equal to its input) and the per-step lerp of `<k>` ..
`<k>_end` extras; and TabuSearch's f64 delta branch, which runs where the
fused kernel turns the instance down (i64 accumulation)."""

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

from _port_parity import (vrp_pair, to_np, assert_tree_equal,
                          tabu_state_to_port, jit_integer_stages, step_keys,
                          warm_jax_state)
from greyjack_tpu_torch.agents import TabuSearch
from greyjack_tpu_torch.agents import base as tbase
from greyjack_tpu_torch.agents.termination_strategies import StepsLimit
from greyjack_tpu_torch.interop import from_numpy_tree
from greyjack_tpu_torch.models.vrp import delta_kernel
from greyjack_tpu_torch.ops import moves as tmoves
from greyjack_tpu_torch.parallel import IslandRunner as TRunner

torch.set_num_threads(1)

_PROBAS = [0.5, 0.5, 0, 0, 0, 0]
_N_ISL = 4


def _toy_kernels(self_gating):
    """A kernel in each package whose step adds the per-step `rate` extra
    to a running f64 sum and counts its steps; the self-gating one reads
    `_active`, the other relies on the runner's mask."""

    def jstep(key, st, ex):
        on = ex.get("_active", True)
        return {"x": jnp.where(on, st["x"] + ex["rate"], st["x"]),
                "n": st["n"] + jnp.where(on, 1, 0).astype(jnp.int32)}

    def tstep(gens, st, ex):
        on = ex.get("_active", torch.ones(st["n"].shape, dtype=torch.bool))
        return {"x": torch.where(on[:, None], st["x"] + ex["rate"][:, None],
                                 st["x"]),
                "n": st["n"] + on.to(torch.int32)}

    def kern(step):
        return SimpleNamespace(metaheuristic_kind="LocalSearch",
                               population_size=1, migration_rate=1.0,
                               step=step, prestep=None, refresh=None,
                               self_gating=self_gating)

    return kern(jstep), kern(tstep)


@pytest.mark.parametrize("self_gating", [False, True])
def test_steps_mask_and_lerp_match_jax(self_gating):
    rng = np.random.default_rng(5)
    jk, tk = _toy_kernels(self_gating)
    n_steps = 7
    islands = {"x": rng.random((_N_ISL, 3)),
               "n": rng.integers(0, 5, _N_ISL).astype(np.int32)}
    extras = {"rate": rng.random(_N_ISL), "rate_end": rng.random(_N_ISL),
              "other": rng.random(_N_ISL)}
    alive = np.array([True, False, True, True])
    steps_left = np.array([n_steps, n_steps, 3, n_steps], np.int32)
    jr = JRunner(jk, n_islands=_N_ISL, migration_frequency=n_steps)
    tr = TRunner(tk, n_islands=_N_ISL, migration_frequency=n_steps)
    want = jr._steps(jax.tree.map(jnp.asarray, islands), jax.random.key(0),
                     jnp.asarray(alive), jnp.asarray(steps_left),
                     jax.tree.map(jnp.asarray, extras), n_steps, _N_ISL)
    got = tr._steps(from_numpy_tree(islands, device="cpu"), None,
                    torch.from_numpy(alive), torch.from_numpy(steps_left),
                    from_numpy_tree(extras, device="cpu"),
                    n_steps)
    assert_tree_equal(to_np(want), got, "islands")
    # the dead island is its input, bit for bit; island 2 froze after 3
    np.testing.assert_array_equal(got["x"][1].numpy(), islands["x"][1])
    np.testing.assert_array_equal(got["n"].numpy() - islands["n"],
                                  [n_steps, 0, 3, n_steps])
    # the lerp: rate + (rate_end - rate) * i / n_steps, summed over steps
    frac = np.arange(n_steps) / n_steps
    per_step = (extras["rate"][:, None]
                + (extras["rate_end"] - extras["rate"])[:, None] * frac)
    np.testing.assert_allclose(got["x"][0].numpy() - islands["x"][0],
                               per_step[0].sum(), rtol=1e-12)


def test_mask_state_freezes_inactive_islands():
    rng = np.random.default_rng(1)
    old = {"a": torch.from_numpy(rng.random((3, 2, 4))),
           "b": {"c": torch.from_numpy(rng.integers(0, 9, (3,)))}}
    new = {"a": torch.from_numpy(rng.random((3, 2, 4))),
           "b": {"c": torch.from_numpy(rng.integers(0, 9, (3,)))}}
    alive = torch.tensor([True, False, True])
    out = tbase.mask_state(new, old, alive)
    assert torch.equal(out["a"][1], old["a"][1])
    assert torch.equal(out["b"]["c"][[0, 2]], new["b"]["c"][[0, 2]])
    assert out["b"]["c"][1] == old["b"]["c"][1]


@pytest.fixture(scope="module")
def i64_tabu():
    """TabuSearch kernels of both packages on an instance whose bounds need
    i64 accumulation, and a warm JAX state of 3 islands."""
    mp = pytest.MonkeyPatch()
    mp.delenv("GJ_PALLAS_INTERPRET", raising=False)
    jreq, treq, _, _ = vrp_pair(True, n=30, d=2, kveh=5, seed=3, greedy=True,
                                span=20000.0)
    jit_integer_stages(mp, [jreq])
    args = (32, 0.2, True, None, _PROBAS, 2)
    jk = JTabuSearch(*args, JSteps(10)).build_kernel(jreq, None)
    tk = TabuSearch(*args, StepsLimit(10)).build_kernel(treq, None)
    yield jreq, treq, jk, tk, warm_jax_state(jk, 3, 4, 2)
    mp.undo()


def test_tabu_f64_delta_step_matches_jax(monkeypatch, i64_tabu):
    jreq, treq, jk, tk, st = i64_tabu
    # the calculator registers int rows, but the kernel turns this
    # instance down (i64 accumulation) and the step scores f64 rows; the
    # label is the JAX package's for the same configuration ("int-delta")
    assert tk.path == jk.path == "int-delta"
    assert not treq.delta_ints_eligible(2)
    assert treq._delta_utils()["acc_dtype"] == torch.int64
    vm = jreq.variables_manager
    jcfg = jmoves.MoverConfig(vm, 0.2, None, _PROBAS)
    orig = jmoves.move_population_delta
    sample = jax.jit(lambda k, base, tabu, free: orig(k, base, 32, vm, jcfg,
                                                      tabu, free))
    monkeypatch.setattr(jmoves, "move_population_delta",
                        lambda k, base, n, vm_, cfg, tabu, free=None:
                        sample(k, base, tabu, free))
    keys = step_keys(9, 0, 3)
    free = jcfg.tabu_free(st["tabu"])
    active = np.array([True, True, False])
    fed = jax.vmap(lambda key, base, tabu, fl, fc: sample(
        jax.random.split(key)[0], base, tabu, (fl, fc)))(
        keys, st["population"][:, 0], st["tabu"], free[0], free[1])
    new = jax.vmap(jk.step)(keys, st, {"_free": free,
                                       "_active": jnp.asarray(active)})

    tst = tabu_state_to_port(st)
    tfed = from_numpy_tree(to_np(fed), device="cpu")
    monkeypatch.setattr(tmoves, "move_population_delta", lambda *a, **k: tfed)
    before = delta_kernel._call_kernel.launches
    tnew = tk.step(None, tst, {"_free": tk.prestep(tst)["_free"],
                               "_active": torch.from_numpy(active)})
    assert delta_kernel._call_kernel.launches == before
    assert_tree_equal(to_np(new), tnew, "state")
    moved = np.any(np.asarray(new["population"])
                   != np.asarray(st["population"]), axis=(1, 2))
    assert moved[:2].any() and not moved[2]


def test_tabu_path_label_without_int_rows():
    _, treq, _, _ = vrp_pair(True, n=30, d=2, kveh=5, seed=3)
    treq.cotwin.score_calculator.delta_score_batch_ints_fn = None
    tk = TabuSearch(16, 0.2, True, None, _PROBAS, 2,
                    StepsLimit(10)).build_kernel(treq, None)
    assert tk.path == "delta"
    state = tk.init_state([torch.Generator().manual_seed(i)
                           for i in range(2)])
    new = tk.step([torch.Generator().manual_seed(7 + i) for i in range(2)],
                  state, tk.prestep(state))
    want = treq.ctx_score_row(treq.build_base_ctx(new["population"][:, 0]))
    assert torch.equal(new["scores"][:, 0], want)
