"""`score_precision` composed with the fast paths, torch port vs the JAX
package: the twin of the VRP cases of `tests/test_score_precision.py`.

At precisions [3, 3, 1] (a coarse soft level that merges distinct milli
values) and [0, 0, 3] (the VRP example's), TabuSearch's random-move and
sweep kernels and LateAcceptance's / SimulatedAnnealing's random-move and
sweep kernels must report the path the JAX package's kernels report for
the same configuration, and a few island steps of each port kernel must
leave stored scores and island bests equal to a rounded plain rescore, bit
for bit. `make_rounded_ints_to_row_fn` must equal the JAX one bit for bit.
Tolerance: none."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from greyjack_tpu.agents import (TabuSearch as JTS, LateAcceptance as JLA,
                                 SimulatedAnnealing as JSA)
from greyjack_tpu.agents import base as jbase
from greyjack_tpu.agents.termination_strategies import StepsLimit as JSteps
from greyjack_tpu.models.vrp import CotwinBuilder as JCotwinBuilder
from greyjack_tpu.models.vrp import generate_instance as j_generate
from greyjack_tpu.score_calculation.score_requesters import (
    ScoreRequester as JScoreRequester)
from greyjack_tpu_torch.agents import (TabuSearch, LateAcceptance,
                                       SimulatedAnnealing)
from greyjack_tpu_torch.agents import base as tbase
from greyjack_tpu_torch.agents.termination_strategies import StepsLimit
from greyjack_tpu_torch.models.vrp import CotwinBuilder, generate_instance
from greyjack_tpu_torch.parallel import IslandRunner
from greyjack_tpu_torch.score_calculation.score_requesters import (
    ScoreRequester)
from greyjack_tpu_torch.solver.solver import island_generators

torch.set_num_threads(1)

_PRECISIONS = [[3, 3, 1], [0, 0, 3]]
_NARROW = [0.5, 0.5, 0, 0, 0, 0]


@pytest.fixture(scope="module")
def reqs():
    """Both packages' requesters of `test_score_precision.py`'s VRP
    instance (n=24, 2 depots, 6 vehicles, time windows)."""
    jd = j_generate(24, 2, 6, seed=11, time_windowed=True)
    td = generate_instance(24, 2, 6, seed=11, time_windowed=True,
                           device="cpu")
    return (JScoreRequester(JCotwinBuilder(True, True).build_cotwin(jd,
                                                                    False)),
            ScoreRequester(CotwinBuilder(True, True).build_cotwin(td, False)))


def _agent(pkg, name):
    """(agent, expected path) of one configuration in either package."""
    ts, la, sa = (JTS, JLA, JSA) if pkg == "jax" else (TabuSearch,
                                                       LateAcceptance,
                                                       SimulatedAnnealing)
    steps = (JSteps if pkg == "jax" else StepsLimit)(50)
    sweep = dict(sweep=True, sweep_targets=6)
    return {
        "TS-random": (lambda: ts(32, 0.2, True, None, _NARROW, 5, steps),
                      "int-delta"),
        "TS-six-move": (lambda: ts(16, 0.2, True, None, None, 5, steps),
                        "int-delta"),
        "TS-sweep": (lambda: ts(16, 0.2, True, None, _NARROW, 5, steps,
                                **sweep), "sweep"),
        "LA-random": (lambda: la(10, 0.2, None, _NARROW, 5, steps), "delta"),
        "LA-sweep": (lambda: la(10, 0.2, None, _NARROW, 5, steps, **sweep),
                     "sweep"),
        "SA-random": (lambda: sa([5.0, 5.0, 1.0], 0.999, 0.2, None, _NARROW,
                                 5, steps), "delta"),
        "SA-sweep": (lambda: sa([5.0, 5.0, 1.0], 0.999, 0.2, None, _NARROW,
                                5, steps, **sweep), "sweep"),
    }[name]


@pytest.mark.parametrize("precision", _PRECISIONS)
@pytest.mark.parametrize("name", ["TS-random", "TS-six-move", "TS-sweep",
                                  "LA-random", "LA-sweep", "SA-random",
                                  "SA-sweep"])
def test_paths_engage_as_in_jax_and_scores_stay_rounded(reqs, name,
                                                        precision):
    jreq, treq = reqs
    make_j, want = _agent("jax", name)
    make_t, _ = _agent("torch", name)
    jk = make_j().build_kernel(jreq, precision)
    tk = make_t().build_kernel(treq, precision)
    assert tk.path == jk.path == want

    n_isl = 3
    runner = IslandRunner(tk, n_isl, 5)
    gens = island_generators(3, n_isl, "cpu")
    state = runner.init(gens)
    alive = torch.ones(n_isl, dtype=torch.bool)
    for _ in range(3):
        state = runner.run_chunk(state, gens, alive, {}, 5)
    isl = state["islands"]
    fn = tbase.make_score_fn(treq, precision)
    pop = isl["population"][:, 0]
    assert torch.equal(isl["scores"][:, 0], fn(pop))
    assert torch.equal(isl["top_score"], fn(isl["top_values"]))
    assert torch.equal(state["global_score"],
                       fn(state["global_values"][None])[0])
    assert (isl["step_id"] == 15).all()
    if want == "sweep":
        assert (isl["sweep_scored"] > 0).all()
    # the search moved: rounded scores really were compared
    assert not torch.equal(pop, treq.variables_manager.initial_values[None]
                           .expand_as(pop))


@pytest.mark.parametrize("precision", _PRECISIONS)
def test_rounded_ints_to_row_bit_equal(reqs, precision):
    jreq, treq = reqs
    rng = np.random.default_rng(4)
    ints = np.stack([rng.integers(0, 3000, 64), rng.integers(0, 10 ** 7, 64),
                     rng.integers(0, 10 ** 8, 64)], axis=-1).astype(np.int64)
    ints[:3] = [[3, 0, 123457], [0, 7, 999999], [1, 1, 1000]]
    want = np.asarray(jax.vmap(jbase.make_rounded_ints_to_row_fn(
        jreq, precision))(jnp.asarray(ints)))
    got = tbase.make_rounded_ints_to_row_fn(treq, precision)(
        torch.from_numpy(ints))
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("precision", _PRECISIONS)
def test_rounded_plain_score_bit_equal(reqs, precision):
    jreq, treq = reqs
    vm = treq.variables_manager
    pop = torch.stack([vm.sample_variables(g, 8)
                       for g in island_generators(5, 2, "cpu")]).reshape(
                           16, -1)
    want = np.asarray(jbase.make_score_fn(jreq, precision)(
        jnp.asarray(pop.numpy())))
    got = tbase.make_score_fn(treq, precision)(pop)
    np.testing.assert_array_equal(got.numpy(), want)
