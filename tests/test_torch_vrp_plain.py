"""VRP plain path of the torch port vs the JAX package: the distance
matrix, the utility objects and the plain score rows must be bit-equal."""

import numpy as np
import pytest

import jax.numpy as jnp

from _port_parity import vrp_pair, assert_leaf_equal

import torch

from greyjack_tpu_torch.ops import segments, routes


@pytest.mark.parametrize("tw", [True, False])
def test_distance_matrix_and_utils(tw):
    jreq, treq, jd, td = vrp_pair(tw, greedy=True)
    assert_leaf_equal(jd.distance_matrix, td.distance_matrix, "dm")
    ju = jreq.cotwin.score_calculator.utility_objects
    tu = treq.cotwin.score_calculator.utility_objects
    for key in ("distance_matrix_milli", "dm_flat_milli", "cust_packed",
                "work_day_start_k", "work_day_end_k", "capacities",
                "vehicle_depot_ids", "demand_by_vec_id"):
        assert_leaf_equal(ju[key], tu[key], key)
    for key in ("route_cap", "n_stops", "n_locations", "k_vehicles",
                "dm_max_milli", "t_max", "time_windowed"):
        assert ju[key] == tu[key], key
    assert (ju["acc_dtype"] == jnp.int32) == (tu["acc_dtype"] == torch.int32)
    # the greedy init gives both packages the same initial values
    np.testing.assert_array_equal(
        np.asarray(jreq.variables_manager.initial_values),
        treq.variables_manager.initial_values.numpy())


@pytest.mark.parametrize("tw", [True, False])
def test_plain_score_rows_bit_equal(tw):
    jreq, treq, jd, td = vrp_pair(tw)
    n_depots, n_loc, k = 2, 42, 6
    n_stops = n_loc - n_depots
    rng = np.random.default_rng(5)
    pop = np.zeros((24, 2 * n_stops), np.float32)
    pop[:, 0::2] = rng.integers(0, k, size=(24, n_stops))
    pop[:, 1::2] = rng.integers(n_depots, n_loc, size=(24, n_stops))
    # a few out-of-range and fractional entries exercise fix_all
    pop[0, 0] = k + 3
    pop[1, 1] = 7.5
    pop[2, 3] = 2.49
    want = np.asarray(jreq.request_score_plain(jnp.asarray(pop)))
    got = treq.request_score_plain(torch.from_numpy(pop))
    assert_leaf_equal(want, got, "scores")
    # the frames the scores come from
    jf = jreq.build_frames(jnp.asarray(pop))["planning_stops"]
    tf = treq.build_frames(torch.from_numpy(pop))["planning_stops"]
    for col in ("vehicle_id", "customer_id"):
        assert_leaf_equal(jf[col], tf[col], col)


def test_segment_and_scan_ops():
    from greyjack_tpu.ops import segments as jseg, routes as jroutes
    rng = np.random.default_rng(9)
    vals = rng.integers(0, 12, size=(5, 30)).astype(np.int32)
    want = [float(jseg.count_minus_n_unique(jnp.asarray(v), 12)) for v in vals]
    got = segments.count_minus_n_unique(torch.from_numpy(vals)).numpy()
    np.testing.assert_array_equal(got, want)
    ids = rng.integers(0, 4, size=(30,)).astype(np.int32)
    want = np.asarray(jseg.segment_sum(jnp.asarray(vals[0]),
                                       jnp.asarray(ids), 4))
    got = segments.segment_sum(torch.from_numpy(vals[0]),
                               torch.from_numpy(ids), 4)
    assert_leaf_equal(want, got, "segment_sum")
    sv, perm = jroutes.sort_stops_by_vehicle(jnp.asarray(ids))
    tsv, tperm = routes.sort_stops_by_vehicle(torch.from_numpy(ids))
    np.testing.assert_array_equal(tsv.numpy(), np.asarray(sv))
    np.testing.assert_array_equal(tperm.numpy(), np.asarray(perm))
    adds = rng.integers(0, 50, size=(3, 37)).astype(np.int32)
    floors = rng.integers(0, 500, size=(3, 37)).astype(np.int32)
    adds[:, ::7] = -(1 << 30)
    want = np.asarray(jroutes._maxplus_scan(jnp.asarray(adds),
                                            jnp.asarray(floors)))
    got = routes._maxplus_scan(torch.from_numpy(adds),
                               torch.from_numpy(floors))
    assert_leaf_equal(want, got, "maxplus")


@pytest.mark.parametrize("tw", [True, False])
def test_set_constraint_weights_matches_jax(tw):
    """Reweighting constraints of the plain VRP cotwin changes
    `score_batch` exactly as the JAX calculator's reweighting does."""
    from _port_parity import plain_pair

    jreq, treq = plain_pair(tw=tw)
    rng = np.random.default_rng(8)
    vm = treq.variables_manager
    lo = vm.lower_bounds.numpy()
    hi = vm.upper_bounds.numpy()
    pop = np.floor(lo + rng.random((12, lo.shape[0])) * (hi - lo + 1)
                   ).astype(np.float32)
    before = treq.request_score_plain(torch.from_numpy(pop))
    weights = {"capacity_constraint": 3.0, "minimize_distance": 0.25,
               "late_arrival_penalty": 2.5}
    if not tw:
        weights.pop("late_arrival_penalty")
    for req in (jreq, treq):
        req.cotwin.score_calculator.set_constraint_weights(weights)
    assert treq.cotwin.score_calculator.constraint_weights \
        == jreq.cotwin.score_calculator.constraint_weights
    want = np.asarray(jreq.request_score_plain(jnp.asarray(pop)))
    got = treq.request_score_plain(torch.from_numpy(pop))
    assert_leaf_equal(want, got, "reweighted scores")
    assert not torch.equal(got, before)
    np.testing.assert_array_equal(got[:, 2].numpy(),
                                  0.25 * before[:, 2].numpy())
