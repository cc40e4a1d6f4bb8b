"""TSP model of the torch port vs the JAX package (n <= 36): the instance,
utility objects and greedy start, the plain scores (fast and exact), the
tour-distance ops, the delta ctx, `score_delta`, `ctx_score_row`,
`ctx_int_totals` and `update_ctx` must be bit-equal, dtypes included;
`read_tsp_file` must read a TSPLIB file as the JAX scanner does; and a
`Solver.solve` twin of `tests/test_tsp.py`'s must keep a valid tour no
worse than the greedy one. Integer arrays are compared against jitted JAX,
f64 rows against eager JAX. Tolerance: none."""

import inspect

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from greyjack_tpu.models.tsp import cotwin_builder as jcb
from greyjack_tpu.models.tsp import domain as jdomain
from greyjack_tpu.ops import routes as jroutes

from _port_parity import (tsp_pair, assert_leaf_equal, assert_tree_equal,
                          stack_states, perturbed_tours, base_ctxs)
from greyjack_tpu_torch.agents import TabuSearch
from greyjack_tpu_torch.agents.termination_strategies import StepsLimit
from greyjack_tpu_torch.models import tsp
from greyjack_tpu_torch.models.tsp import cotwin_builder as tcb
from greyjack_tpu_torch.ops import routes
from greyjack_tpu_torch.solver import Solver, SolverLoggingLevels

torch.set_num_threads(1)

_N = 24


def _population(n, p, seed):
    """Random-permutation tours, tours with duplicates and uniform rows."""
    rng = np.random.default_rng(seed)
    pop = rng.integers(1, n, size=(p, n - 1)).astype(np.float32)
    for i in range(p // 2):
        pop[i] = rng.permutation(np.arange(1, n))
    pop[0, 2] = pop[0, 5]
    return pop


def test_instance_utils_and_greedy_start():
    jreq, treq, jd, td = tsp_pair(_N, seed=3)
    assert_leaf_equal(jd.distance_matrix, td.distance_matrix, "dm")
    ju = jreq.cotwin.score_calculator.utility_objects
    tu = treq.cotwin.score_calculator.utility_objects
    for key in ("distance_matrix_milli", "dm_flat_milli"):
        assert_leaf_equal(ju[key], tu[key], key)
    for key in ("n_locations", "dm_max_milli", "exact_fp_scores"):
        assert ju[key] == tu[key], key
    np.testing.assert_array_equal(
        np.asarray(jreq.variables_manager.initial_values),
        treq.variables_manager.initial_values.numpy())
    assert sorted(tcb.greedy_tour(td.distance_matrix.numpy()).tolist()) \
        == list(range(1, _N))
    np.testing.assert_array_equal(
        tcb.greedy_tour(td.distance_matrix.numpy()),
        jcb.greedy_tour(np.asarray(jd.distance_matrix)))
    assert [(x.id, x.latitude, x.longitude, x.name) for x in td.locations_vec] \
        == [(x.id, x.latitude, x.longitude, x.name) for x in jd.locations_vec]
    assert treq.supports_sweep and treq.supports_rounded_fast_paths
    assert treq.cotwin.score_calculator.score_int_scales == [1.0, 1000.0]


@pytest.mark.parametrize("exact", [False, True])
def test_plain_scores_bit_equal(exact):
    jreq, treq, _, _ = tsp_pair(_N, seed=5, exact=exact)
    pop = _population(_N, 24, 1)
    want = np.asarray(jreq.request_score_plain(jnp.asarray(pop)))
    got = treq.request_score_plain(torch.from_numpy(pop))
    assert_leaf_equal(want, got, "scores")
    assert (want[:, 0] == 0).any() and (want[:, 0] > 0).any()
    # exact and fast delta kernels are registered only for the fast scores
    assert treq.supports_delta == (not exact)


def test_tour_distance_ops_bit_equal():
    _, treq, jd, td = tsp_pair(_N, seed=7)
    stops = _population(_N, 12, 2).astype(np.int32)
    stops[3] = 0                               # the depot everywhere
    dm = np.asarray(jd.distance_matrix)
    want = np.stack([np.asarray(jroutes.tour_distance(jnp.asarray(s),
                                                      jnp.asarray(dm)))
                     for s in stops])
    got = routes.tour_distance(torch.from_numpy(stops), td.distance_matrix)
    assert_leaf_equal(want, got, "tour_distance")
    # the one-stop tour folds no chain leg
    one = routes.tour_distance(torch.from_numpy(stops[:, :1]),
                               td.distance_matrix)
    assert_leaf_equal(np.stack([np.asarray(jroutes.tour_distance(
        jnp.asarray(s[:1]), jnp.asarray(dm))) for s in stops]), one, "one")
    milli = treq._delta_utils()["distance_matrix_milli"]
    flat = milli.reshape(-1)
    jm = jnp.asarray(milli.numpy())
    for dm_at in (None, "flat"):
        want = np.stack([np.asarray(jroutes.tour_distance_fast(
            jnp.asarray(s), jm, dm_at=None if dm_at is None
            else (lambda i: jm.reshape(-1)[i]), n_locations=_N))
            for s in stops])
        got = routes.tour_distance_fast(
            torch.from_numpy(stops), milli, n_locations=_N,
            dm_at=None if dm_at is None else (lambda i: flat[i.long()]))
        assert_leaf_equal(want, got, f"tour_distance_fast dm_at={dm_at}")


def test_delta_ctx_and_ctx_scores_bit_equal():
    jreq, treq, _, _ = tsp_pair(_N, seed=3)
    jctx, tctx = base_ctxs(jreq, treq, perturbed_tours(jreq))
    assert_tree_equal(stack_states(jctx), tctx, "ctx")
    ju, tu = jreq._delta_utils(), treq._delta_utils()
    assert_leaf_equal(np.stack([np.asarray(jcb.ctx_score_row(c, ju))
                                for c in jctx]),
                      tcb.ctx_score_row(tctx, tu), "ctx_score_row")
    assert_leaf_equal(np.stack([np.asarray(jcb.ctx_int_totals(c, ju))
                                for c in jctx]),
                      tcb.ctx_int_totals(tctx, tu), "ctx_int_totals")
    assert (np.asarray(stack_states(jctx)["hard"]) == [0, 1]).all()


def _deltas(rng, n_isl, m, k, n_rows, n_loc):
    """Deltas [I, M, K]: some invalid entries, a repeated position (with
    its value: a delta's repeats carry equal values) and values that
    duplicate stops."""
    pos = np.argsort(rng.random((n_isl, m, n_rows)), axis=-1)[..., :k]
    pos = pos.astype(np.int32)
    val = rng.integers(1, n_loc, size=(n_isl, m, k)).astype(np.float32)
    valid = rng.random((n_isl, m, k)) < 0.8
    pos[:, 0, 1] = pos[:, 0, 0]
    val[:, 0, 1] = val[:, 0, 0]
    valid[:, 1] = False
    return {"positions": pos, "values": val, "valid": valid}


def _jax_delta(d, i, m=None):
    sl = (i,) if m is None else (i, m)
    return {k: jnp.asarray(x[sl]) for k, x in d.items()}


@pytest.mark.parametrize("k", [2, 16])
def test_score_delta_bit_equal(k):
    jreq, treq, _, _ = tsp_pair(_N, seed=3)
    jctx, tctx = base_ctxs(jreq, treq, perturbed_tours(jreq))
    ju = jreq._delta_utils()
    d = _deltas(np.random.default_rng(k), 2, 12, k, _N - 1, _N)
    want = np.stack([np.stack([np.asarray(jcb.score_delta(
        jctx[i], _jax_delta(d, i, m), ju)) for m in range(12)])
        for i in range(2)])
    got = tcb.score_delta(tctx, {kk: torch.from_numpy(x)
                                 for kk, x in d.items()},
                          treq._delta_utils())
    assert_leaf_equal(want, got, "score_delta")
    # each row equals a full rescore of the patched tour
    from greyjack_tpu_torch.ops import moves
    bases = perturbed_tours(jreq)
    for i in range(2):
        patched = moves.apply_delta(
            torch.from_numpy(bases[i:i + 1]).expand(12, -1),
            {kk: torch.from_numpy(x[i]) for kk, x in d.items()})
        assert torch.equal(treq.request_score_plain(patched), got[i])


@pytest.mark.parametrize("width", ["narrow", "full"])
def test_update_ctx_bit_equal(width):
    jreq, treq, _, _ = tsp_pair(_N, seed=3)
    bases = perturbed_tours(jreq)
    jctx, tctx = base_ctxs(jreq, treq, bases)
    ju, tu = jreq._delta_utils(), treq._delta_utils()
    n = _N - 1
    rng = np.random.default_rng(3)
    if width == "narrow":
        d = {k: x[:, 0] for k, x in _deltas(rng, 2, 2, 4, n, _N).items()}
    else:
        # a full-width winner (a reversal of the whole tour, as the sweep
        # emits one), and an island whose delta has no valid entry
        d = {"positions": np.tile(np.arange(n, dtype=np.int32), (2, 1)),
             "values": bases[:, ::-1].copy(),
             "valid": np.stack([np.ones(n, bool), np.zeros(n, bool)])}
    up = jax.jit(lambda c, dd: jcb.update_ctx(c, dd, ju))
    want = stack_states([up(jctx[i], _jax_delta(d, i)) for i in range(2)])
    got = tcb.update_ctx(tctx, {k: torch.from_numpy(x) for k, x in d.items()},
                         tu)
    assert_tree_equal(want, got, "update_ctx")
    # the updated ctx is the ctx of the patched tour
    from greyjack_tpu_torch.ops import moves
    patched = moves.apply_delta(torch.from_numpy(bases),
                                {k: torch.from_numpy(x) for k, x in d.items()})
    assert_tree_equal(got, treq.build_base_ctx(patched), "rebuilt")


def _write_tsplib(path, explicit=False):
    lines = ["NAME : tiny6", "COMMENT : six cities",
             f"TYPE : TSP", "DIMENSION : 6",
             "EDGE_WEIGHT_TYPE : " + ("EXPLICIT" if explicit else "EUC_2D"),
             "NODE_COORD_SECTION"]
    pts = [(0, 1.5, 2.25), (1, 10.0, 3.0), (2, 4.125, 8.5), (3, 7.0, 7.0),
           (4, 2.0, 9.75), (5, 12.5, 0.5)]
    for i, x, y in pts:
        lines.append(f"{i}   {x} {y}" + (f" city{i}" if i % 2 else ""))
    lines.append("EOF")
    if explicit:
        for i in range(6):
            lines.append(" ".join(f"{abs(i - j) * 1.23456:.5f}"
                                  for j in range(6)))
        lines.append("EOF")
    path.write_text("\n".join(lines) + "\n")


@pytest.mark.parametrize("explicit", [False, True])
def test_read_tsp_file_matches_jax(tmp_path, monkeypatch, explicit):
    f = tmp_path / "tiny.tsp"
    _write_tsplib(f, explicit)
    # both packages' pure-Python scanners (their native tokenizers off;
    # `tests/test_torch_native_io.py` holds the native paths)
    import greyjack_tpu.native as jnative
    monkeypatch.setattr(jnative, "parse_instance", lambda path: None)
    monkeypatch.setattr(tsp.domain, "parse_instance", lambda path: None)
    meta, locs, matrix = tsp.domain.read_tsp_file(str(f))
    jmeta, jlocs, jmatrix = jdomain.read_tsp_file(str(f))
    assert meta == jmeta
    assert [(x.id, x.latitude, x.longitude, x.name) for x in locs] \
        == [(x.id, x.latitude, x.longitude, x.name) for x in jlocs]
    if explicit:
        np.testing.assert_array_equal(matrix, jmatrix)
    else:
        assert matrix is None and jmatrix is None
    dom = tsp.DomainBuilder(str(f), device="cpu").build_domain_from_scratch()
    jdom = jdomain.DomainBuilder(str(f)).build_domain_from_scratch()
    assert_leaf_equal(jdom.distance_matrix, dom.distance_matrix, "dm")
    assert dom.name == jdom.name == "tiny6"


def test_entry_points_default_to_the_card():
    for fn in (tsp.generate_uniform_instance, tsp.DomainBuilder):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    dom = tsp.generate_uniform_instance(8, seed=1, device="cpu")
    cot = tsp.CotwinBuilder(True, True).build_cotwin(dom, False)
    assert cot.score_calculator.device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            tsp.generate_uniform_instance(8, seed=1)


def test_solver_improves_over_greedy():
    """Twin of `tests/test_tsp.py::test_solver_improves_over_greedy`."""
    db = tsp.DomainBuilder.from_generator(
        lambda: tsp.generate_uniform_instance(24, seed=11, device="cpu"))
    agent = TabuSearch(64, 0.2, True, None, [0.0, 0.2, 0.2, 0.2, 0.2, 0.2],
                       5, StepsLimit(40))
    sol = Solver.solve(db, tsp.CotwinBuilder(True, True), agent, n_jobs=2,
                       score_precision=[3, 3],
                       logging_level=SolverLoggingLevels.Silent, seed=1)
    domain = db.build_from_solution(sol)
    assert sol[1]["hard_score"] == 0.0
    assert domain.get_unique_stops_count() == 23
    greedy = db.build_domain_from_scratch()
    greedy.trip_path = tcb.greedy_tour(
        greedy.distance_matrix.numpy()).tolist()
    assert domain.get_travel_distance() <= greedy.get_travel_distance() + 1e-9
