"""The generic ops the TSP / N-Queens slice added to the port vs the JAX
package: `segments.n_unique` / `segment_count` / `overflow_penalty`, the
join lookups (`sort_merge_lookup`, `sort_merge_lookup_with_dups`,
`iota_table_lookup`, `counts_from_sorted`) and `routes.vrp_routes_fast`.
Every result must be bit-equal, dtype included, row by row against the
JAX function: integer results (and integer counts as f64) against the
jitted `jax.vmap` of it, the VRP walk's f64 totals against eager JAX,
where `x / 1000.0` stays a true division."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from greyjack_tpu.ops import join as jjoin, routes as jroutes
from greyjack_tpu.ops import segments as jseg

from _port_parity import assert_leaf_equal, vrp_pair
from greyjack_tpu_torch.ops import join, routes, segments

torch.set_num_threads(1)


def _t(x):
    return torch.from_numpy(np.array(x))


def test_n_unique_and_segment_count_bit_equal():
    rng = np.random.default_rng(3)
    # values below 0 count at bucket 0 and values >= the bucket count are
    # dropped, as `jnp.bincount` counts them
    vals = rng.integers(-3, 15, size=(6, 40)).astype(np.int32)
    want = np.asarray(jax.jit(jax.vmap(lambda v: jseg.n_unique(v, 12)))(
        jnp.asarray(vals)))
    got = segments.n_unique(_t(vals), 12)
    assert_leaf_equal(want, got, "n_unique")
    want = np.asarray(jax.jit(jax.vmap(
        lambda v: jseg.segment_count(v, 12)))(jnp.asarray(vals)))
    got = segments.segment_count(_t(vals), 12)
    assert_leaf_equal(want, got, "segment_count")
    assert want.dtype == np.int64 and (vals < 0).any() and (vals >= 12).any()


@pytest.mark.parametrize("dtype", [np.int32, np.float64])
def test_overflow_penalty_bit_equal(dtype):
    rng = np.random.default_rng(4)
    demands = rng.integers(0, 40, size=(5, 30)).astype(dtype)
    ids = rng.integers(0, 4, size=(5, 30)).astype(np.int32)
    caps = np.array([200, 150, 260, 90], dtype)
    demands[0] //= 10                       # a row with no overflow
    fn = jax.jit(jax.vmap(lambda d, s: jseg.overflow_penalty(
        d, s, jnp.asarray(caps), 4)))
    want = np.asarray(fn(jnp.asarray(demands), jnp.asarray(ids)))
    got = segments.overflow_penalty(_t(demands), _t(ids), _t(caps), 4)
    assert_leaf_equal(want, got, "overflow_penalty")
    assert (want > 0).any() and (want == 0).any()


@pytest.mark.parametrize("cols", [0, 3])
def test_sort_merge_lookups_bit_equal(cols):
    rng = np.random.default_rng(5 + cols)
    l = 17
    shape = (l,) if cols == 0 else (l, cols)
    table = rng.integers(-500, 500, size=shape).astype(np.int32)
    # in range, repeated, and outside [0, L) on both sides: a key below 0
    # finds no table row (0), a key above finds the last row
    keys = rng.integers(-4, l + 4, size=(4, 50)).astype(np.int32)
    keys[0, :3] = [-1, l, l + 9]
    jt = jnp.asarray(table)
    jk = jnp.asarray(keys)
    want = np.asarray(jax.jit(jax.vmap(
        lambda k: jjoin.sort_merge_lookup(jt, k)))(jk))
    assert_leaf_equal(want, join.sort_merge_lookup(_t(table), _t(keys)),
                      "sort_merge_lookup")
    w_out, w_dup = jax.jit(jax.vmap(
        lambda k: jjoin.sort_merge_lookup_with_dups(jt, k)))(jk)
    g_out, g_dup = join.sort_merge_lookup_with_dups(_t(table), _t(keys))
    assert_leaf_equal(w_out, g_out, "with_dups rows")
    assert_leaf_equal(w_dup, g_dup, "with_dups count")

    # the iota lookup's contract is keys in [0, L)
    ik = np.clip(keys, 0, l - 1)
    jik = jnp.asarray(ik)
    want = np.asarray(jax.jit(jax.vmap(
        lambda k: jjoin.iota_table_lookup(jt, k)))(jik))
    assert_leaf_equal(want, join.iota_table_lookup(_t(table), _t(ik)),
                      "iota_table_lookup")
    w_out, w_dup = jax.jit(jax.vmap(
        lambda k: jjoin.iota_table_lookup(jt, k, with_dups=True)))(jik)
    g_out, g_dup = join.iota_table_lookup(_t(table), _t(ik), with_dups=True)
    assert_leaf_equal(w_out, g_out, "iota rows")
    assert_leaf_equal(w_dup, g_dup, "iota dups")
    np.testing.assert_array_equal(g_out.numpy(), table[ik])


def test_counts_from_sorted_bit_equal():
    rng = np.random.default_rng(6)
    keys = np.sort(rng.integers(0, 20, size=(5, 60)), axis=-1).astype(
        np.int32)
    want = np.asarray(jax.jit(jax.vmap(jjoin.counts_from_sorted))(
        jnp.asarray(keys)))
    assert_leaf_equal(want, join.counts_from_sorted(_t(keys)),
                      "counts_from_sorted")


@pytest.mark.parametrize("tw", [True, False])
def test_vrp_routes_fast_bit_equal(tw):
    """The loop-free VRP walk on random assignments, stops stably sorted by
    vehicle; the f64 totals against eager JAX (its `/ 1000.0` is a true
    division there)."""
    jreq, treq, jd, _ = vrp_pair(tw, n=30, d=2, kveh=5, seed=7)
    l = 32
    rng = np.random.default_rng(8)
    p, n = 6, 30
    v = rng.integers(0, 5, size=(p, n)).astype(np.int32)
    c = rng.integers(2, l, size=(p, n)).astype(np.int32)
    order = np.argsort(v, axis=-1, kind="stable")
    sv = np.take_along_axis(v, order, -1)
    sc = np.take_along_axis(c, order, -1)
    cust = jd.customers_vec
    veh = jd.vehicles
    ju = jreq.cotwin.score_calculator.utility_objects
    tables = dict(
        vehicle_depot_ids=np.array([x.depot_vec_id for x in veh], np.int32),
        work_day_start=np.array([x.work_day_start for x in veh], np.int32),
        work_day_end=np.array([x.work_day_end for x in veh], np.int32),
        tw_start=np.array([x.time_window_start for x in cust], np.int32),
        tw_end=np.array([x.time_window_end for x in cust], np.int32),
        service_time=np.array([x.service_time for x in cust], np.int32))
    if not tw:
        for key in ("work_day_start", "work_day_end", "tw_start", "tw_end",
                    "service_time"):
            tables[key] = None
    jtab = {k: None if x is None else jnp.asarray(x)
            for k, x in tables.items()}
    dm = np.asarray(ju["distance_matrix_milli"])
    want = [jroutes.vrp_routes_fast(
        jnp.asarray(sv[i]), jnp.asarray(sc[i]), jnp.asarray(dm),
        num_vehicles=5, **jtab) for i in range(p)]
    want = tuple(np.stack([np.asarray(w[j]) for w in want]) for j in (0, 1))
    got = routes.vrp_routes_fast(
        _t(sv), _t(sc), _t(dm), num_vehicles=5,
        **{k: None if x is None else _t(x) for k, x in tables.items()})
    assert_leaf_equal(want[0], got[0], "distance")
    assert_leaf_equal(want[1], got[1], "lateness")
    if tw:
        assert (want[1] > 0).all()
    # the same walk as the port's packed one, which the VRP plain score runs
    tu = treq._delta_utils()
    packed = routes.vrp_routes_packed(
        _t(sv), _t(sc), tu["dm_flat_milli"], l, tu["vehicle_depot_ids"],
        tu["work_day_start_k"], tu["work_day_end_k"],
        tu["cust_packed"][_t(sc).long()], tw)
    assert torch.equal(packed[0], got[0]) and torch.equal(packed[1], got[1])
