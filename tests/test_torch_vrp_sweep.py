"""VRP sweep neighbourhood of the torch port vs the JAX package at n=30:
`SweepConfig`, the per-step tables, every candidate family, the
deterministic half of `propose` and `exact_score_row` must be bit-equal,
dtypes included. Two islands with different perturbed greedy bases run as
one batch in the port and one by one in the JAX package. The JAX side runs
eagerly (the f64 score row must match eager JAX; the integer arrays would
match jitted JAX as well)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from greyjack_tpu.models.vrp import sweep as jsweep
from greyjack_tpu.ops import moves as jmoves, selection as jsel

from _port_parity import (vrp_pair, assert_leaf_equal, assert_tree_equal,
                          jax_sweep_targets)
from greyjack_tpu_torch.interop import from_numpy_tree
from greyjack_tpu_torch.models.vrp import sweep as tsweep
from greyjack_tpu_torch.ops import moves as tmoves, selection as tsel

torch.set_num_threads(1)

_PROBAS = [0.5, 0.5, 0, 0, 0, 0]
# tw / window / seed of tests/test_sweep.py's family parity cases
_PARAMS = [(True, 4, 3), (True, 16, 5), (False, 8, 3)]
_ISLANDS = 2


def _pair(tw, seed):
    jreq, treq, _, _ = vrp_pair(tw, n=30, d=2, kveh=5, seed=seed,
                                greedy=True)
    return jreq, treq


def _perturbed_bases(jreq, n_isl=_ISLANDS, n_moves=12):
    """Greedy-init bases with a few random narrow moves applied, a
    different set per island (as tests/test_sweep.py's `_perturbed_base`:
    waiting routes, violated windows, duplicates)."""
    vm = jreq.variables_manager
    ids = jreq.planning_schema["planning_stops"]["var_ids_np"]
    upper = np.asarray(vm.upper_bounds)
    n_rows = len(ids["customer_id"])
    out = []
    for i in range(n_isl):
        kr = np.random.RandomState(7 + i)
        arr = np.asarray(vm.initial_values).copy()
        for _ in range(n_moves):
            a, b = kr.randint(n_rows), kr.randint(n_rows)
            arr[ids["vehicle_id"][a]] = kr.randint(
                int(upper[ids["vehicle_id"][a]]) + 1)
            ca, cb = ids["customer_id"][a], ids["customer_id"][b]
            arr[ca], arr[cb] = arr[cb], arr[ca]
        out.append(arr)
    return np.stack(out)


def _ctxs(jreq, treq, bases):
    jctx = [jreq.build_base_ctx(jnp.asarray(b)) for b in bases]
    tctx = treq.build_base_ctx(torch.from_numpy(bases))
    return jctx, tctx


def _stack(trees):
    return jax.tree.map(lambda *x: np.stack([np.asarray(v) for v in x]),
                        *trees)


def test_sweep_config_matches():
    jreq, treq = _pair(True, 3)
    assert jsweep.eligible(jreq._delta_utils())
    assert tsweep.eligible(treq._delta_utils())
    assert treq.supports_sweep and treq.sweep_module is tsweep
    for targets, window in ((12, 8), (64, 16)):
        jc = jsweep.SweepConfig(jreq, targets, window)
        tc = tsweep.SweepConfig(treq, targets, window)
        for attr in ("targets", "window", "n_rows", "g_cust", "g_veh",
                     "cust_group_lmax"):
            assert getattr(jc, attr) == getattr(tc, attr), attr
        for attr in ("frozen_cust_np", "frozen_veh_np"):
            np.testing.assert_array_equal(getattr(jc, attr),
                                          getattr(tc, attr))
        for attr in ("cust_var", "veh_var", "frozen_cust", "frozen_veh",
                     "row_of_cust_slot", "slot_of_row_cust",
                     "slot_of_row_veh", "cust_slot_valid", "dm", "dmT"):
            assert_leaf_equal(getattr(jc, attr), getattr(tc, attr), attr)
        for rate in (0.0, 0.2):
            assert (jc.conservative_moves_per_step(jreq._delta_utils(), rate)
                    == tc.conservative_moves_per_step(treq._delta_utils(),
                                                      rate))
    # the port's defaults are the reference's (its environment unset)
    tc = tsweep.SweepConfig(treq)
    assert (tc.targets, tc.window) == (min(64, tc.n_rows), 16)
    with pytest.raises(ValueError):
        tsweep.SweepConfig(treq, 0, 8)


@pytest.mark.parametrize("tw,window,seed", _PARAMS)
def test_build_tables_bit_equal(tw, window, seed):
    jreq, treq = _pair(tw, seed)
    bases = _perturbed_bases(jreq)
    jctx, tctx = _ctxs(jreq, treq, bases)
    jc = jsweep.SweepConfig(jreq, 30, window)
    tc = tsweep.SweepConfig(treq, 30, window)
    ju = jreq._delta_utils()
    want = _stack([jsweep.build_tables(c, jc, ju) for c in jctx])
    got = tsweep.build_tables(tctx, tc, treq._delta_utils())
    assert want[0].shape == (_ISLANDS, 30, 20 + 4 * window)
    assert_tree_equal(want, got, "tables")


def _targets(rng, n, t, n_isl=_ISLANDS):
    """Distinct target rows per island, some invalid, and a non-empty
    partner-tabu mask."""
    t_rows = np.stack([rng.permutation(n)[:t] for _ in range(n_isl)]
                      ).astype(np.int32)
    t_valid = rng.random((n_isl, t)) < 0.8
    row_tabu = rng.random((n_isl, n)) < 0.2
    assert not t_valid.all() and row_tabu.any()
    return t_rows, t_valid, row_tabu


@pytest.mark.parametrize("tw,window,seed", _PARAMS)
def test_score_candidates_bit_equal(tw, window, seed):
    jreq, treq = _pair(tw, seed)
    bases = _perturbed_bases(jreq)
    jctx, tctx = _ctxs(jreq, treq, bases)
    n = 30
    jc = jsweep.SweepConfig(jreq, n, window)
    tc = tsweep.SweepConfig(treq, n, window)
    t_rows, t_valid, row_tabu = _targets(np.random.default_rng(seed), n, n)
    ju = jreq._delta_utils()
    want = _stack([jsweep.score_candidates(
        jctx[i], jnp.asarray(t_rows[i]), jnp.asarray(t_valid[i]),
        jnp.asarray(row_tabu[i]), jc, ju) for i in range(_ISLANDS)])
    got = tsweep.score_candidates(
        tctx, torch.from_numpy(t_rows), torch.from_numpy(t_valid),
        torch.from_numpy(row_tabu), tc, treq._delta_utils())
    assert_tree_equal(want, got, "families")
    assert want["b_late"].dtype == (np.int64 if tw else np.int32)
    assert want["b_dist"].dtype == np.int64
    # the cases exercise what they are meant to
    assert want["a_valid"].any() and want["b_valid"].any()
    assert want["c_valid"].any()
    if tw and window <= 4:
        assert (want["c_valid"] & ~want["c_conv"]).any()


def _tabu_states(jcfg, groups, n_isl=_ISLANDS, n_push=6):
    """One JAX tabu ring per island, with a few slot pushes into `groups`
    (the customer and vehicle groups)."""
    states = []
    for i in range(n_isl):
        st = jcfg.init_tabu_state()
        rng = np.random.default_rng(50 + i)
        for j in range(n_push):
            g = groups[j % len(groups)]
            pos = rng.integers(0, 30, size=2).astype(np.int32)
            st = jsel.tabu_push(st, jnp.int32(g), jnp.asarray(pos),
                                jnp.int32(2))
        states.append(st)
    return states


@pytest.mark.parametrize("tw,window,seed", _PARAMS)
def test_propose_from_jax_targets_bit_equal(tw, window, seed):
    jreq, treq = _pair(tw, seed)
    bases = _perturbed_bases(jreq)
    jctx, tctx = _ctxs(jreq, treq, bases)
    ju, tu = jreq._delta_utils(), treq._delta_utils()
    jc = jsweep.SweepConfig(jreq, 12, window)
    tc = tsweep.SweepConfig(treq, 12, window)
    jm = jmoves.MoverConfig(jreq.variables_manager, 0.2, None, _PROBAS)
    tm = tmoves.MoverConfig(treq.variables_manager, 0.2, None, _PROBAS)
    jtabu = _tabu_states(jm, (jc.g_cust, jc.g_veh))
    keys = jax.random.split(jax.random.key(seed), _ISLANDS)
    want, rows = [], []
    for i in range(_ISLANDS):
        free = jm.tabu_free(jtabu[i])
        masks = jm.tabu_masks(jtabu[i])
        want.append(jsweep.propose(keys[i], jctx[i], free, masks, jc, ju))
        rows.append(jax_sweep_targets(keys[i], free, jctx[i]["base_over"],
                                      jc))
    want = _stack(want)
    t_rows = torch.from_numpy(np.stack([r[0] for r in rows]))
    t_valid = torch.from_numpy(np.stack([r[1] for r in rows]))

    ttabu = from_numpy_tree(_stack(jtabu), device="cpu")
    row_tabu = tsweep.tabu_rows(tm.tabu_masks(ttabu), tc, _ISLANDS)
    assert row_tabu.any()
    got = tsweep.propose_from_targets(tctx, t_rows, t_valid, row_tabu, tc,
                                      tu)
    assert_tree_equal(want, got, "propose")
    # the exact row is the real delta of the winner, not a stub
    assert (want[1][:, 0] != np.iinfo(np.int32).max).all()
    assert want[3]["n_scored"].min() > 0


def test_sample_targets_contract():
    """The port draws its own targets (streams differ from jax.random):
    distinct tabu-free customer rows, valid up to the free count."""
    _, treq = _pair(True, 3)
    tc = tsweep.SweepConfig(treq, 12, 8)
    tm = tmoves.MoverConfig(treq.variables_manager, 0.2, None, _PROBAS)
    tabu = tm.init_tabu_state(_ISLANDS)
    tabu = tsel.tabu_push(tabu, torch.tensor([1, 1], dtype=torch.int32),
                          torch.tensor([[0, 3], [5, 6]], dtype=torch.int32),
                          torch.tensor([2, 2], dtype=torch.int32))
    free = tm.tabu_free(tabu)
    bases = torch.from_numpy(_perturbed_bases(_pair(True, 3)[0]))
    ctx = treq.build_base_ctx(bases)
    from greyjack_tpu_torch.solver.solver import island_generators
    t_rows, t_valid = tsweep.sample_targets(
        island_generators(1, _ISLANDS, "cpu"), ctx, free, tc)
    assert t_rows.shape == (_ISLANDS, 12) and t_rows.dtype == torch.int32
    assert t_valid.all()
    tabu_row = tsweep.tabu_rows(tm.tabu_masks(tabu), tc, _ISLANDS)
    for i in range(_ISLANDS):
        assert len(set(t_rows[i].tolist())) == 12
        assert not tabu_row[i, t_rows[i].long()].any()


@pytest.mark.parametrize("tw", [True, False])
def test_exact_score_row_matches_eager_jax(tw):
    jreq, treq = _pair(tw, 5)
    bases = _perturbed_bases(jreq)
    jctx, tctx = _ctxs(jreq, treq, bases)
    stub = np.iinfo(np.int32).max
    exact = np.array([[1000, -37, 12345], [stub, 5, 7]], np.int32)
    want = np.stack([np.asarray(jsweep.exact_score_row(
        jctx[i], jnp.asarray(exact[i]), jreq._delta_utils()))
        for i in range(_ISLANDS)])
    got = tsweep.exact_score_row(tctx, torch.from_numpy(exact),
                                 treq._delta_utils())
    assert_leaf_equal(want, got, "exact_score_row")
    assert want[1, 0] == np.finfo(np.float64).max - 1.0
