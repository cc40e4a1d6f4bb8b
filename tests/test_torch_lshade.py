"""LSHADE and the mixed-int model, torch port vs the JAX package.

The LSHADE step's deterministic body, fed the leaves the JAX step draws
from the same key (`_port_parity.jax_lshade_noise`) and the JAX state,
gives the JAX step's state:

  * bit for bit: population, scores (VRP), island best, archive, `arc_f`,
    `arc_cr`, `arc_ids`, `arc_count`, `k`, tabu rings and step count;
  * the adaptive memories (`adaptive_f` / `_cr` / `_mp`) within a relative
    1e-12: they are weighted Lehmer means, f64 reductions whose order
    differs between XLA and torch;
  * F (the Cauchy draw, through `tan`, which is not bit-portable between
    XLA and torch) within 4 ulp, its f32 rounding exact;
  * mixed-int scores (`cos` and an f64 sum over the variables) within a
    relative 1e-13.

Every decision that reads an inexact value is required exact (first
positive draw, crossover / move branch, improved, accepted, the archive
keep-set), and the test asserts that no compared margin lies inside the
tolerance. The hazards of the translation each have a case: stable sorts
of tied f32 uniforms, the `mode="drop"` archive push, the first positive
of a bool row, and the runner carrying the archive state through
`mask_state` and the Population migration untouched.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from greyjack_tpu.agents import LSHADE as JLSHADE
from greyjack_tpu.agents.termination_strategies import StepsLimit as JSteps
from greyjack_tpu.ops import moves as jmoves
from greyjack_tpu.parallel.islands import IslandRunner as JRunner

from _port_parity import (plain_pair, mixedint_pair, stack_states,
                          stack_leaves, assert_tree_equal, jax_lshade_noise,
                          to_np)
from greyjack_tpu_torch.agents import LSHADE, Individual
from greyjack_tpu_torch.agents import base as tbase
from greyjack_tpu_torch.agents import lshade as tl
from greyjack_tpu_torch.agents.termination_strategies import StepsLimit
from greyjack_tpu_torch.interop import from_numpy_tree
from greyjack_tpu_torch.models.mixedint import (CotwinBuilder as MICotwin,
                                                DomainBuilder as MIDomain)
from greyjack_tpu_torch.parallel import IslandRunner
from greyjack_tpu_torch.score_calculation.scores import SimpleScore
from greyjack_tpu_torch.solver import Solver, SolverLoggingLevels, SolverMetrics
from greyjack_tpu_torch.solver.solver import island_generators

torch.set_num_threads(1)

_N_ISL = 3
_P_BEST = 0.2
_ULPS = 4
_ADAPT_RTOL = 1e-12
_MIXED_RTOL = 1e-13
_ADAPTIVE = ("adaptive_f", "adaptive_cr", "adaptive_mp")


def _lshade(pkg, p, h, prune, g, probas, mult=None, mp0=0.9):
    args = (p, h, _P_BEST, prune, g, 0.5, 0.5, mp0, 0.2, mult, probas, 0.25,
            4)
    if pkg == "jax":
        return JLSHADE(*args, JSteps(10))
    return LSHADE(*args, StepsLimit(10))


def _ulp_close(got, want, ulps=_ULPS):
    got, want = np.asarray(got), np.asarray(want)
    return np.abs(got - want) <= ulps * np.spacing(np.abs(want))


def _jax_f(loc_f, u_c):
    """F and the 8 capped draws as the JAX step computes them
    (`lshade.py:108-118`), eager."""
    f_draws = jnp.minimum(jnp.asarray(loc_f)[..., None]
                          + 0.1 * jnp.tan(jnp.pi * (jnp.asarray(u_c) - 0.5)),
                          1.0)
    pos = f_draws > 0.0
    first = jnp.argmax(pos, axis=-1)
    f = jnp.where(jnp.any(pos, axis=-1),
                  jnp.take_along_axis(f_draws, first[..., None], -1)[..., 0],
                  jnp.maximum(jnp.asarray(loc_f), 0.1))
    return np.asarray(f), np.asarray(f_draws)


def _check_f(tstate, leaves, prop):
    """F within 4 ulp of the JAX formula's, with every decision margin of
    it (positive draw, the cap at 1, the f32 rounding) outside 4 ulp."""
    rid = leaves["rid"].long()
    loc = torch.gather(tstate["adaptive_f"], 1, rid).numpy()
    jf, jdraws = _jax_f(loc, leaves["u_c"].numpy())
    got = prop["f"].numpy()
    assert _ulp_close(got, jf).all()
    assert (got.astype(np.float32) == jf.astype(np.float32)).all()
    raw = loc[..., None] + 0.1 * np.tan(np.pi * (leaves["u_c"].numpy() - 0.5))
    tol = _ULPS * np.spacing(np.abs(raw) + 1.0)
    assert (np.abs(raw) > tol).all(), "a draw's sign lies inside 4 ulp"
    assert (np.abs(raw - 1.0) > tol).all(), "a draw lies within 4 ulp of 1"
    # the f32 rounding of F: no F lies within 4 ulp of a rounding midpoint
    f32 = jf.astype(np.float32)
    mid = np.where(jf > f32, (f32.astype(np.float64)
                              + np.nextafter(f32, np.float32(2)).astype(
                                  np.float64)) / 2,
                   (f32.astype(np.float64) + np.nextafter(
                       f32, np.float32(-2)).astype(np.float64)) / 2)
    assert (np.abs(jf - mid) > _ULPS * np.spacing(np.abs(jf))).all()


def _check_decisions(jreq, tstate, prop, mixed):
    """The port's candidates rescored by the JAX package: scores within the
    stated tolerance (exact on the VRP), and improved / accepted exact with
    every margin outside it."""
    cand = prop["candidates"]
    n_isl, p, v = cand.shape
    jscores = np.asarray(jreq.request_score_plain(
        jnp.asarray(cand.reshape(n_isl * p, v).numpy()))).reshape(n_isl, p, -1)
    got = prop["cand_scores"].numpy()
    if mixed:
        np.testing.assert_allclose(got, jscores, rtol=_MIXED_RTOL, atol=0)
    else:
        np.testing.assert_array_equal(got, jscores)
    prev = tl.priority(tstate["scores"]).numpy()
    jprio = tl.priority(torch.from_numpy(jscores.copy())).numpy()
    tprio = tl.priority(prop["cand_scores"]).numpy()
    assert ((tprio < prev) == (jprio < prev)).all()
    assert ((tprio <= prev) == (jprio <= prev)).all()
    if mixed:
        margin = np.abs(jprio - prev)
        assert (margin > 2 * _MIXED_RTOL * np.abs(prev)).all(), \
            "an improved / accepted margin lies inside the tolerance"


def _compare_state(want, got, mixed, label):
    want = dict(want)
    got = dict(got)
    for key in _ADAPTIVE:
        w = np.asarray(want.pop(key))
        g = got.pop(key).numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, key
        np.testing.assert_allclose(g, w, rtol=_ADAPT_RTOL, atol=0,
                                   err_msg=f"{label} {key}")
    if mixed:
        for key in ("scores", "top_score"):
            w = np.asarray(want.pop(key))
            g = got.pop(key).numpy()
            assert g.dtype == w.dtype and g.shape == w.shape, key
            np.testing.assert_allclose(g, w, rtol=_MIXED_RTOL, atol=0,
                                       err_msg=f"{label} {key}")
    assert_tree_equal(want, got, label)


def _run_steps(jreq, treq, p, h, prune, g, probas, n_steps, mixed,
               mult=None, seed=1):
    """`n_steps` JAX steps of `_N_ISL` islands (eager, per island); before
    each, the port's body takes the JAX state and the JAX step's leaves.
    Returns what the steps did, for the callers' coverage asserts."""
    jk = _lshade("jax", p, h, prune, g, probas, mult).build_kernel(jreq)
    tk = _lshade("torch", p, h, prune, g, probas, mult).build_kernel(treq)
    assert jk.path == tk.path == "plain" and tk.moves_per_step == p
    jvm = jreq.variables_manager
    jcfg = jmoves.MoverConfig(jvm, 0.2, mult, probas)
    states = [jk.init_state(k)
              for k in jax.random.split(jax.random.key(seed), _N_ISL)]
    seen = {"move": False, "cross": False, "improved": 0, "prune": False}
    for step in range(n_steps):
        keys = jax.random.split(
            jax.random.fold_in(jax.random.key(seed + 1), step), _N_ISL)
        new = [jk.step(keys[i], states[i], {}) for i in range(_N_ISL)]
        leaves = stack_leaves([jax_lshade_noise(k, p, h, g, _P_BEST, jvm,
                                                jcfg, jnp.float32)
                               for k in keys])
        tstate = from_numpy_tree(stack_states(states), device="cpu")
        prop = tk.propose(tstate, leaves)
        _check_f(tstate, leaves, prop)
        _check_decisions(jreq, tstate, prop, mixed)
        tnew = tk.body(tstate, leaves)
        want = stack_states(new)
        _compare_state(want, tnew, mixed, f"step {step}")
        seen["move"] |= bool(prop["use_move"].any())
        seen["cross"] |= bool((~prop["use_move"]).any())
        improved = torch.sum(tl.priority(prop["cand_scores"])
                             < tl.priority(tstate["scores"]), dim=-1)
        seen["improved"] += int(improved.sum())
        seen["prune"] |= bool((tstate["arc_count"] + improved > h).any())
        states = new
    return seen, want


@pytest.fixture(scope="module")
def vrp():
    return plain_pair()


@pytest.mark.parametrize("g", [1, 0])
def test_lshade_body_bit_equal_vrp(vrp, g):
    jreq, treq = vrp
    seen, want = _run_steps(jreq, treq, 16, 16, 0.5, g,
                            [0.5, 0.5, 0, 0, 0, 0], 3, mixed=False)
    # both branches taken, candidates archived
    assert seen["move"] and seen["cross"]
    assert seen["improved"] > 0
    assert (np.asarray(want["arc_count"]) > 0).all()


def test_lshade_body_six_moves_vrp(vrp):
    jreq, treq = vrp
    seen, _ = _run_steps(jreq, treq, 8, 16, 0.5, 1, None, 2, mixed=False,
                         mult=1.0, seed=5)
    assert seen["move"] and seen["cross"]


def test_lshade_body_prune_step(vrp):
    """h = 4 with P = 16: the archive passes h in a step and is pruned to
    ceil(0.5 * 4) = 2 rows."""
    jreq, treq = vrp
    seen, want = _run_steps(jreq, treq, 16, 4, 0.5, 1,
                            [0.5, 0.5, 0, 0, 0, 0], 3, mixed=False, seed=7)
    assert seen["prune"]
    assert (np.asarray(want["arc_count"]) <= 4).all()


@pytest.mark.parametrize("g", [1, 0])
def test_lshade_body_mixedint_rastrigin(g):
    jreq, treq = mixedint_pair(4, 4, "rastrigin")
    seen, want = _run_steps(jreq, treq, 16, 16, 0.1, g, None, 3, mixed=True,
                            seed=11)
    assert seen["move"] and seen["cross"] and seen["improved"] > 0
    # integer slots stay integral
    pop = np.asarray(want["population"])
    assert (pop[..., 4:] == np.round(pop[..., 4:])).all()


@pytest.mark.parametrize("objective", ["rastrigin", "rosenbrock", "sphere"])
@pytest.mark.parametrize("nf,ni", [(4, 4), (3, 0), (0, 5)])
def test_mixedint_scores_match_jax(objective, nf, ni):
    jreq, treq = mixedint_pair(nf, ni, objective)
    vm = treq.variables_manager
    assert vm.discrete_ids == jreq.variables_manager.discrete_ids
    pop = torch.cat([vm.sample_variables(g, 32)
                     for g in island_generators(3, 2, "cpu")])
    pop = torch.cat([pop, pop * 1.7 - 0.3])                  # fix_all clamps
    want = np.asarray(jreq.request_score_plain(jnp.asarray(pop.numpy())))
    got = treq.request_score_plain(pop)
    assert got.dtype == torch.float64 and got.shape == want.shape == (128, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=_MIXED_RTOL, atol=0)


def test_forced_columns_stable_on_ties():
    """Tied f32 column uniforms: the forced columns are those
    `jnp.argsort(jnp.argsort(gsel))` (stable) picks."""
    rng = np.random.default_rng(0)
    gsel = (rng.integers(0, 3, (2, 5, 40)) / 4.0).astype(np.float32)
    cnt = rng.integers(1, 6, (2, 5)).astype(np.int32)
    jorder = jnp.argsort(jnp.asarray(gsel), axis=-1)
    want = np.asarray(jnp.argsort(jorder, axis=-1) < cnt[..., None])
    got = tl.forced_columns(torch.from_numpy(gsel), torch.from_numpy(cnt))
    np.testing.assert_array_equal(got.numpy(), want)


def test_prune_order_stable_on_ties():
    rng = np.random.default_rng(1)
    cap, h, keep = 12, 6, 3
    noise = (rng.integers(0, 3, (4, cap)) / 4.0)
    count = np.array([4, 8, 12, 7], np.int32)
    order, new_count = tl.prune_order(torch.from_numpy(noise),
                                      torch.from_numpy(count), h, keep)
    for i in range(4):
        live = np.arange(cap) < count[i]
        keyed = jnp.where(live, noise[i], 2.0)
        rank = jnp.argsort(jnp.argsort(keyed))
        kp = live & np.asarray(rank < keep)
        kp = kp if count[i] > h else live
        want = np.asarray(jnp.argsort(~kp, stable=True))
        np.testing.assert_array_equal(order[i].numpy(), want)
        assert int(new_count[i]) == (min(count[i], keep) if count[i] > h
                                     else count[i])


@pytest.mark.parametrize("count", [0, 9, 17, 20])
def test_archive_push_drops_as_jax_does(count):
    """`.at[slot].set(mode="drop")` with the arena nearly full: the rows
    that do not fit are dropped, and the port's scatter never sees a
    repeated target row."""
    rng = np.random.default_rng(count)
    cap, p, v = 20, 8, 3
    arena = rng.random((1, cap, v))
    src = rng.random((1, p, v))
    improved = rng.random((1, p)) < 0.6
    improved[0, :2] = True
    slot = tl.archive_slots(torch.tensor([count], dtype=torch.int32),
                            torch.from_numpy(improved), cap)
    assert len(set(slot[0].tolist())) == p
    got = tl.push_rows(torch.from_numpy(arena), slot, torch.from_numpy(src))
    imp = jnp.asarray(improved[0])
    jslot = (count + jnp.cumsum(imp).astype(jnp.int32)
             - imp.astype(jnp.int32))
    jslot = jnp.where(imp & (jslot < cap), jslot, cap)
    want = jnp.asarray(arena[0]).at[jslot].set(jnp.asarray(src[0]),
                                               mode="drop")
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want))


def test_cauchy_first_positive_of_bool_row():
    """The first positive draw is taken from an int view (`torch.argmax`
    rejects bool), and a row with no positive draw falls back to
    max(loc, 0.1), as the JAX step's `jnp.argmax(pos)` does."""
    loc = np.array([0.5, -5.0, 0.05, -0.2, 2.0])
    u_c = np.full((5, 8), 0.01)                       # tan -> large negative
    u_c[0, 3] = 0.6
    u_c[0, 5] = 0.7
    u_c[3, 7] = 0.99
    u_c[4] = 0.5                                      # capped at 1
    got = tl.cauchy_f(torch.from_numpy(loc), torch.from_numpy(u_c)).numpy()
    want, draws = _jax_f(loc, u_c)
    assert _ulp_close(got, want).all()
    assert got[1] == 0.1 and got[2] == 0.1 and got[4] == 1.0
    assert got[0] == pytest.approx(draws[0, 3])
    assert got[3] == pytest.approx(draws[3, 7])


def test_runner_carries_archive_state(vrp):
    """`mask_state` and the Population migration carry `archive`, `arc_*`,
    `adaptive_*` and `k` through untouched, as the JAX runner does."""
    jreq, treq = vrp
    probas = [0.5, 0.5, 0, 0, 0, 0]
    jk = _lshade("jax", 8, 8, 0.5, 1, probas).build_kernel(jreq)
    tk = _lshade("torch", 8, 8, 0.5, 1, probas).build_kernel(treq)
    jr, tr = JRunner(jk, _N_ISL, 4), IslandRunner(tk, _N_ISL, 4)
    assert tr.migrants_count == jr.migrants_count == 2
    islands = jr.init(jax.random.key(4))["islands"]
    # the state is only an input here: the steps run jitted
    step = jax.jit(jax.vmap(lambda k, st: jk.step(k, st, {})))
    for s in range(2):
        islands = step(jax.random.split(jax.random.key(20 + s), _N_ISL),
                       islands)
    t_islands = from_numpy_tree(to_np(islands), device="cpu")
    assert int(t_islands["arc_count"].sum()) > 0
    carried = ("archive", "arc_f", "arc_cr", "arc_ids", "arc_count", "k",
               "tabu") + _ADAPTIVE
    jm = jr._migrate(islands, roll_fn=lambda x: jnp.roll(x, 1, axis=0))
    tm = tr._migrate(t_islands)
    assert_tree_equal(to_np(jm), tm, "migrate")
    for key in carried:
        assert_tree_equal(to_np(islands[key]), tm[key], f"migrate {key}")
    # a dead island keeps its whole state, the archive included
    gens = island_generators(9, _N_ISL, "cpu")
    stepped = tk.step(gens, t_islands, {})
    alive = torch.tensor([True, False, True])
    masked = tbase.mask_state(stepped, t_islands, alive)
    def island(tree, i):
        if isinstance(tree, dict):
            return {k: island(x, i) for k, x in tree.items()}
        return tree[i]

    assert_tree_equal(island(to_np(islands), 1), island(masked, 1),
                      "masked island")
    assert torch.equal(masked["arc_count"][[0, 2]],
                       stepped["arc_count"][[0, 2]])


def test_draw_leaves(vrp):
    _, treq = vrp
    tk = _lshade("torch", 6, 5, 0.5, 2, [0.5, 0.5, 0, 0, 0, 0]
                 ).build_kernel(treq)
    gens = [torch.Generator().manual_seed(i) for i in range(2)]
    leaves = tk.draw(gens)
    v = treq.variables_manager.variables_count
    assert leaves["rid"].dtype == torch.int32
    assert ((leaves["rid"] >= 0) & (leaves["rid"] < 5)).all()
    assert ((leaves["cnt"] >= 1) & (leaves["cnt"] <= 2)).all()
    assert leaves["u_c"].shape == (2, 6, 8)
    assert leaves["u_mask"].dtype == leaves["gsel"].dtype == torch.float32
    assert leaves["u_mask"].shape == (2, 6, v)
    assert ((leaves["u_pb"] >= 1e-5) & (leaves["u_pb"] < _P_BEST)).all()
    assert leaves["u_prune"].shape == (2, 11)
    assert torch.isfinite(leaves["n_cr"]).all()
    assert leaves["move"]["gumbel"].shape[:2] == (2, 6)
    state = tk.init_state(gens)
    new = tk.step(gens, state, {})
    assert (new["step_id"] == 1).all()
    assert (new["arc_count"] <= 5).all()


def test_normal_from_uniform_matches_erfinv_normals():
    u = torch.tensor([0.0, 0.5, 0.975, 1e-300, 0.999999],
                     dtype=torch.float64)
    z = tl.normal_from_uniform(u)
    assert torch.isfinite(z).all()
    assert z[1] == 0.0
    assert abs(float(z[2]) - 1.959963984540054) < 1e-12


def _initial_best(agent, db, cb, seed, n_jobs):
    from greyjack_tpu_torch.score_calculation.score_requesters import (
        ScoreRequester)
    req = ScoreRequester(cb.build_cotwin(db.build_domain_from_scratch(),
                                         False))
    state = IslandRunner(agent.build_kernel(req), n_jobs, 10).init(
        island_generators(seed, n_jobs, "cpu"))
    return float(state["islands"]["scores"][..., 0].min()), req


@pytest.mark.parametrize("case", ["sphere-8f", "sphere-4f4i"])
def test_lshade_solve_improves_and_rescores(case):
    if case == "sphere-8f":
        db = MIDomain(8, 0, -5.12, 5.12, "sphere", device="cpu")
        make = lambda: LSHADE(24, 32, 0.2, 0.0, 0, 0.5, 0.5, 0.5, 0.0,  # noqa
                              None, None, 0.25, 10, StepsLimit(80))
        seed, limit = 4, 10.0
    else:
        db = MIDomain(4, 4, -5.12, 5.12, "sphere", device="cpu")
        make = lambda: LSHADE(16, 32, 0.2, 0.1, 1, 0.5, 0.5, 0.5, 0.0,  # noqa
                              None, None, 0.25, 10, StepsLimit(60))
        seed, limit = 14, 40.0
    start, req = _initial_best(make(), db, MICotwin(), seed, 2)
    metrics = SolverMetrics()
    sol = Solver.solve(db, MICotwin(), make(), n_jobs=2,
                       logging_level=SolverLoggingLevels.Silent, seed=seed,
                       metrics=metrics)
    assert {r["kernel_path"] for r in metrics.records} == {"plain"}
    values = [v for _n, v in sol[0]]
    if case == "sphere-4f4i":
        assert all(float(v) == int(v) for v in values[4:])
    rescored = req.request_score_plain(torch.tensor([values],
                                                    dtype=torch.float32))
    assert rescored[0].tolist() == [sol[1]["simple_value"]]
    assert sol[1]["simple_value"] < start
    assert sol[1]["simple_value"] < limit


def test_individual_from_port_state(vrp):
    _, treq = vrp
    tk = _lshade("torch", 6, 6, 0.5, 1, [0.5, 0.5, 0, 0, 0, 0]
                 ).build_kernel(treq)
    runner = IslandRunner(tk, 2, 4)
    gens = island_generators(2, 2, "cpu")
    state = runner.run_chunk(runner.init(gens), gens,
                             torch.ones(2, dtype=torch.bool), {}, 2)
    score_class = treq.score_class
    best = Individual.from_state(state, score_class)
    isl = [Individual.from_state(state, score_class, island=i)
           for i in range(2)]
    np.testing.assert_array_equal(best.variable_values,
                                  state["global_values"].numpy())
    assert best.score == score_class.from_row(state["global_score"].numpy())
    assert min(isl) == best and not best < min(isl)
    assert Individual([0.0], SimpleScore(1.0)) < Individual([0.0],
                                                            SimpleScore(2.0))
