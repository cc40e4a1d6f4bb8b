"""The per-neighbour f64 delta scorer of the torch port vs the JAX package.

`_delta_parts_small` (shift-merge, kd <= 4) and the wide-delta dispatch to
the sorted merge give the JAX package's parts, and `score_delta` its score
rows, bit- and dtype-equal; `ScoreRequester.request_score_delta` equals
JAX's per-neighbour `vmap(score_delta)` both on the fused-kernel route and,
for an instance whose bounds need i64 accumulation (the kernel turns it
down), on the `score_delta` route. Three islands of 48 neighbours each."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from greyjack_tpu.models.vrp import cotwin_builder as jcb
from greyjack_tpu.ops import moves as jmoves

from _port_parity import (vrp_pair, to_np, assert_leaf_equal,
                          assert_tree_equal, jit_integer_stages)
from greyjack_tpu_torch.interop import from_numpy_tree
from greyjack_tpu_torch.models.vrp import cotwin_builder as tcb
from greyjack_tpu_torch.models.vrp import delta_kernel

_N_ISL, _P = 3, 48
_CHANGE_SWAP = [0.5, 0.5, 0, 0, 0, 0]


@pytest.fixture(scope="module")
def pairs():
    """(jax_requester, torch_requester) for time windows on / off and for
    the i64-accumulation instance; the JAX package's integer stages run
    jitted for the whole module."""
    mp = pytest.MonkeyPatch()
    out = {key: vrp_pair(tw, n=30, d=2, kveh=5, seed=3, span=span)[:2]
           for key, tw, span in (("tw", True, 100.0), ("plain", False, 100.0),
                                 ("i64", True, 20000.0))}
    # on the CPU the JAX package scores through vmap(score_delta)
    mp.delenv("GJ_PALLAS_INTERPRET", raising=False)
    jit_integer_stages(mp, [j for j, _ in out.values()])
    yield out
    mp.undo()


def _case(pair, probas, seed, kd=None):
    """Per-island JAX ctx (leaves [I, ...]) and neighbourhoods
    ([I, P, K]) from the JAX sampler; `kd` trims (1) or widens (4, 6: two
    or three draws side by side) the deltas."""
    jreq, _ = pair
    vm = jreq.variables_manager
    cfg = jmoves.MoverConfig(vm, 0.2, None, probas)

    @jax.jit
    def one(key):
        base = vm.sample_variables(key, 1)[0]
        subs = jax.random.split(jax.random.fold_in(key, 1), 3)
        ds = [jmoves.move_population_delta(s, base, _P, vm, cfg,
                                           cfg.init_tabu_state())[0]
              for s in subs]
        return jreq.build_base_ctx(base), ds

    ctxs, dss = jax.vmap(one)(jax.random.split(jax.random.key(seed), _N_ISL))
    if kd is None or kd <= 2:
        deltas = {k: v[..., :kd] for k, v in dss[0].items()}
    else:
        deltas = {k: jnp.concatenate([d[k] for d in dss[:kd // 2]], axis=-1)
                  for k in dss[0]}
    return ctxs, deltas


def _jax_per_neighbour(fn, ctx, deltas):
    return jax.vmap(lambda c, d: jax.vmap(lambda dd: fn(c, dd))(d))(
        ctx, deltas)


_CASES = [
    ("tw", _CHANGE_SWAP, 11, None),
    ("plain", _CHANGE_SWAP, 11, None),
    ("tw", [1.0, 0, 0, 0, 0, 0], 23, None),
    ("tw", [0, 1.0, 0, 0, 0, 0], 37, None),
    ("tw", _CHANGE_SWAP, 5, 1),
    ("plain", _CHANGE_SWAP, 7, 1),
    ("tw", _CHANGE_SWAP, 13, 4),
]


@pytest.mark.parametrize("inst,probas,seed,kd", _CASES)
def test_delta_parts_small_and_score_delta(pairs, inst, probas, seed, kd):
    jreq, treq = pairs[inst]
    uj, ut = jreq._delta_utils(), treq._delta_utils()
    jctx, jdeltas = _case(pairs[inst], probas, seed, kd)
    tctx = from_numpy_tree(to_np(jctx), device="cpu")
    tdeltas = from_numpy_tree(to_np(jdeltas), device="cpu")
    assert tdeltas["positions"].shape[-1] <= tcb._SMALL_DELTA_MAX
    # integer parts: the JAX side jitted (exact for integers)
    want = jax.jit(lambda c, d: _jax_per_neighbour(
        lambda cc, dd: jcb._delta_parts_small(cc, dd, uj), c, d))(
        jctx, jdeltas)
    got = tcb._delta_parts_small(tctx, tdeltas, ut)
    assert_tree_equal(to_np(want), got, "parts")
    # f64 rows: eager JAX, as the port divides by 1000.0
    rows = _jax_per_neighbour(lambda c, d: jcb.score_delta(c, d, uj), jctx,
                              jdeltas)
    assert_leaf_equal(rows, tcb.score_delta(tctx, tdeltas, ut), "rows")
    assert not np.all(np.asarray(rows) == np.asarray(rows)[:, :1]), \
        "the neighbourhood must not score uniformly"


def test_wide_deltas_take_the_sorted_merge(pairs):
    jreq, treq = pairs["tw"]
    uj, ut = jreq._delta_utils(), treq._delta_utils()
    jctx, jdeltas = _case(pairs["tw"], _CHANGE_SWAP, 17, kd=6)
    tctx = from_numpy_tree(to_np(jctx), device="cpu")
    tdeltas = from_numpy_tree(to_np(jdeltas), device="cpu")
    want = to_np(jax.jit(lambda c, d: _jax_per_neighbour(
        lambda cc, dd: jcb._delta_parts_sorted(cc, dd, uj), c, d))(
        jctx, jdeltas))
    got = tcb._delta_parts(tctx, tdeltas, ut)
    # the JAX sort is unstable: the payload left in sentinel slots (past a
    # route's end) is arbitrary there, and zero after `update_ctx`
    n = ut["n_stops"]
    for name in ("r_c", "r_ct", "r_floor", "r_ce"):
        want["bufs"][name] = np.where(want["bufs"]["r_stop"] < n,
                                      want["bufs"][name], 0)
        got["bufs"][name] = torch.where(got["bufs"]["r_stop"] < n,
                                        got["bufs"][name], 0)
    assert_tree_equal(want, got, "parts")
    rows = _jax_per_neighbour(lambda c, d: jcb.score_delta(c, d, uj), jctx,
                              jdeltas)
    assert_leaf_equal(rows, tcb.score_delta(tctx, tdeltas, ut), "rows")


@pytest.mark.parametrize("inst", ["tw", "plain"])
def test_request_score_delta_kernel_route(pairs, inst):
    jreq, treq = pairs[inst]
    ut = treq._delta_utils()
    jctx, jdeltas = _case(pairs[inst], _CHANGE_SWAP, 29)
    tctx = from_numpy_tree(to_np(jctx), device="cpu")
    tdeltas = from_numpy_tree(to_np(jdeltas), device="cpu")
    assert delta_kernel.eligible(ut, tdeltas)
    got = treq.request_score_delta(tctx, tdeltas)
    # the kernel route's rows are the fused scorer's own
    assert_leaf_equal(delta_kernel.score_delta_batch(tctx, tdeltas, ut),
                      got, "kernel rows")
    for i in range(_N_ISL):
        want = jreq.request_score_delta(
            jax.tree.map(lambda x: x[i], jctx),
            jax.tree.map(lambda x: x[i], jdeltas))
        assert_leaf_equal(want, got[i], f"island {i}")


def test_i64_instance_takes_score_delta(pairs):
    jreq, treq = pairs["i64"]
    ut = treq._delta_utils()
    assert ut["acc_dtype"] == torch.int64
    assert jreq._delta_utils()["acc_dtype"] == jnp.int64
    jctx, jdeltas = _case(pairs["i64"], _CHANGE_SWAP, 31)
    tctx = from_numpy_tree(to_np(jctx), device="cpu")
    tdeltas = from_numpy_tree(to_np(jdeltas), device="cpu")
    assert delta_kernel.score_delta_batch(tctx, tdeltas, ut) is None
    assert treq.request_score_delta_ints(tctx, tdeltas) is None
    before = delta_kernel._call_kernel.launches
    got = treq.request_score_delta(tctx, tdeltas)
    assert delta_kernel._call_kernel.launches == before
    assert_leaf_equal(tcb.score_delta(tctx, tdeltas, ut), got, "rows")
    for i in range(_N_ISL):
        want = jreq.request_score_delta(
            jax.tree.map(lambda x: x[i], jctx),
            jax.tree.map(lambda x: x[i], jdeltas))
        assert_leaf_equal(want, got[i], f"island {i}")
