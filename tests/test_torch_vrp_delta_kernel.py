"""The fused VRP delta scorer of the torch port vs the JAX package's Pallas
scorer, case for case as in `tests/test_delta_pallas.py`: the `_pre` kernel
inputs are equal, the plain torch `_kernel_reference` gives the four output
blocks of the Pallas kernel (run in interpret mode), and the f64 and i32
rows equal JAX's `score_delta_batch` / `score_delta_batch_ints`."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from greyjack_tpu.models.vrp import delta_pallas
from greyjack_tpu.ops import moves as jmoves, lexico as jlex

from _port_parity import (vrp_pair, to_np, with_island_axis,
                          assert_leaf_equal)
from greyjack_tpu_torch.interop import from_numpy_tree
from greyjack_tpu_torch.models.vrp import delta_kernel
from greyjack_tpu_torch.ops import lexico as tlex


@pytest.fixture(autouse=True)
def _interp_env(monkeypatch):
    monkeypatch.setenv("GJ_PALLAS_INTERPRET", "1")


def _case(tw, probas, seed, p=128, n_updates=0):
    jreq, treq, _, _ = vrp_pair(tw)
    vm = jreq.variables_manager
    cfg = jmoves.MoverConfig(vm, 0.2, None, probas)
    assert cfg.delta_width <= 2
    tabu = cfg.init_tabu_state()
    key = jax.random.key(seed)
    base = vm.sample_variables(key, 1)[0]
    ctx = jreq.build_base_ctx(base)
    update = jax.jit(jreq.update_ctx)      # integer-only: jit is exact
    for i in range(n_updates):
        d, _ = jmoves.move_population_delta(
            jax.random.fold_in(key, i), base, 1, vm, cfg, tabu)
        w = jax.tree.map(lambda x: x[0], d)
        base = jmoves.apply_delta(base, w)
        ctx = update(ctx, w)
    deltas, _ = jmoves.move_population_delta(
        jax.random.fold_in(key, 99), base, p, vm, cfg, tabu)
    return jreq, treq, ctx, deltas


def _check(jreq, treq, jctx, jdeltas):
    uj, ut = jreq._delta_utils(), treq._delta_utils()
    tctx = from_numpy_tree(with_island_axis(jctx))
    tdeltas = from_numpy_tree(with_island_axis(jdeltas))
    kd = jdeltas["positions"].shape[-1]
    tw = bool(ut["time_windowed"])

    # the integer stages run jitted (one XLA program compiles far faster
    # than op-by-op); the f64 rows run eagerly, because under jit XLA turns
    # the final `/ 1000.0` into a multiply by 0.001, which differs in the
    # last bit — the port divides, as the eager reference does
    jin = jax.jit(lambda c, d: delta_pallas._pre(c, d, uj)[0])(jctx, jdeltas)
    tin, _ = delta_kernel._pre(tctx, tdeltas, ut)
    assert_leaf_equal(jin[0], tin[0][0], "ctx_mat")
    for name, j, t in zip(("av", "sc", "ins", "pay", "el"), jin[1:], tin[1:]):
        assert_leaf_equal(j, t, name)

    jout = jax.jit(lambda i: delta_pallas._call_kernel(i, uj, kd))(jin)
    tout = delta_kernel._kernel_reference(
        *tin, kd=kd, tw=tw, rows_per_island=tin[1].shape[0])
    for name, j, t in zip(("misc", "u", "v", "c"), jout, tout):
        assert_leaf_equal(j, t, name)

    want = delta_pallas.score_delta_batch(jctx, jdeltas, uj)
    got = delta_kernel.score_delta_batch(tctx, tdeltas, ut)
    assert_leaf_equal(want, got[0], "f64 rows")
    want_i = jax.jit(
        lambda c, d: delta_pallas.score_delta_batch_ints(c, d, uj))(
        jctx, jdeltas)
    got_i = delta_kernel.score_delta_batch_ints(tctx, tdeltas, ut)
    assert_leaf_equal(want_i, got_i[0], "i32 rows")
    return tctx, tdeltas, got[0], got_i[0]


@pytest.mark.parametrize("tw", [True, False])
def test_parity_change_swap(tw):
    _check(*_case(tw, [0.5, 0.5, 0.0, 0.0, 0.0, 0.0], seed=11))


def test_parity_change_only_tw():
    _check(*_case(True, [1.0, 0.0, 0.0, 0.0, 0.0, 0.0], seed=23))


def test_parity_swap_only_tw():
    # same-route adjacent customer swaps and two-row vehicle moves
    _check(*_case(True, [0.0, 1.0, 0.0, 0.0, 0.0, 0.0], seed=37))


def test_parity_after_updates():
    _check(*_case(True, [0.5, 0.5, 0, 0, 0, 0], seed=5, n_updates=3))


def test_int_rows_order_equivalent():
    """The port's i32 rows induce exactly the f64 rows' lexicographic order
    and the same accept decision, and the base score materializes from the
    ctx sums."""
    jreq, treq, jctx, jdeltas = _case(True, [0.5, 0.5, 0, 0, 0, 0], seed=41)
    tctx, _, f64, ints = _check(jreq, treq, jctx, jdeltas)
    assert ints.dtype == torch.int32
    lt_f = tlex.lex_less(f64[:, None, :], f64[None, :, :])
    lt_i = tlex.lex_less(ints[:, None, :], ints[None, :, :])
    assert torch.equal(lt_f, lt_i)
    assert int(tlex.lex_argmin(f64)) == int(tlex.lex_argmin(ints))
    base_score = treq.ctx_score_row(tctx)
    acc_f = tlex.lex_leq(f64, base_score)
    acc_i = tlex.lex_leq(ints, torch.zeros_like(ints))
    assert torch.equal(acc_f, acc_i)
    assert_leaf_equal(jreq.ctx_score_row(jctx), base_score[0], "base score")
    assert int(jlex.lex_argmin(jnp.asarray(f64.numpy()))) == int(
        tlex.lex_argmin(f64))


def test_ineligible_returns_none():
    jreq, treq, _, _ = vrp_pair(True)
    ut = treq._delta_utils()
    wide = {"positions": torch.zeros((1, 4, 3), dtype=torch.int32),
            "values": torch.zeros((1, 4, 3)),
            "valid": torch.zeros((1, 4, 3), dtype=torch.bool)}
    assert not delta_kernel.eligible(ut, wide)
    ctx = treq.build_base_ctx(treq.variables_manager.initial_values[None])
    assert delta_kernel.score_delta_batch_ints(ctx, wide, ut) is None


def test_cpu_tensors_take_the_plain_version():
    jreq, treq, jctx, jdeltas = _case(False, [0.5, 0.5, 0, 0, 0, 0], seed=3)
    before = delta_kernel._call_kernel.launches
    _check(jreq, treq, jctx, jdeltas)
    assert delta_kernel._call_kernel.launches == before


def test_other_devices_raise():
    # only CPU tensors take the plain version; anything else that is not
    # CUDA is refused rather than silently computed elsewhere
    meta = tuple(torch.empty((3, 8), dtype=torch.int32, device="meta")
                 for _ in range(6))
    utils = {"time_windowed": True, "k_vehicles": 2}
    with pytest.raises(ValueError):
        delta_kernel._call_kernel(meta, utils, 2, 1)
