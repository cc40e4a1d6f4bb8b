"""VRP delta ctx of the torch port vs the JAX package: `build_delta_ctx`
must be leaf-equal (values and dtypes), and `update_ctx` over accepted
winners sampled by the JAX package must stay leaf-equal both to the JAX
update and to a fresh build of the patched candidate."""

import numpy as np
import pytest
import torch

import jax

from greyjack_tpu.ops import moves as jmoves

from _port_parity import (vrp_pair, to_np, to_torch, with_island_axis,
                          assert_tree_equal)
from greyjack_tpu_torch.interop import from_numpy_tree


def _island(tree, i):
    return {k: v[i] for k, v in tree.items()}


@pytest.mark.parametrize("tw", [True, False])
def test_build_delta_ctx_leaf_equal(tw):
    jreq, treq, _, _ = vrp_pair(tw)
    vm = jreq.variables_manager
    key = jax.random.key(5)
    bases = [vm.sample_variables(jax.random.fold_in(key, i), 1)[0]
             for i in range(3)]
    tctx = treq.build_base_ctx(torch.from_numpy(np.stack(to_np(bases))))
    for i, b in enumerate(bases):
        assert_tree_equal(to_np(jreq.build_base_ctx(b)), _island(tctx, i),
                          f"island{i}")


def test_build_delta_ctx_greedy_base():
    # the solver's starting point: every stop assigned, routes near the cap
    jreq, treq, _, _ = vrp_pair(True, greedy=True)
    base = jreq.variables_manager.initial_values
    tctx = treq.build_base_ctx(to_torch(base)[None])
    assert_tree_equal(to_np(jreq.build_base_ctx(base)), _island(tctx, 0))


@pytest.mark.parametrize("tw,probas", [
    (True, [0.5, 0.5, 0, 0, 0, 0]),
    (False, [0.5, 0.5, 0, 0, 0, 0]),
    (True, [0.0, 1.0, 0, 0, 0, 0]),
])
def test_update_ctx_matches_jax_and_fresh_build(tw, probas):
    jreq, treq, _, _ = vrp_pair(tw)
    vm = jreq.variables_manager
    cfg = jmoves.MoverConfig(vm, 0.2, None, probas)
    tabu = cfg.init_tabu_state()
    key = jax.random.key(17)
    base = vm.sample_variables(key, 1)[0]
    jctx = jreq.build_base_ctx(base)
    tctx = treq.build_base_ctx(to_torch(base)[None])
    start = to_np(jctx)
    for i in range(3):
        d, _ = jmoves.move_population_delta(
            jax.random.fold_in(key, i), base, 1, vm, cfg, tabu)
        w = jax.tree.map(lambda x: x[0], d)
        base = jmoves.apply_delta(base, w)
        jctx = jreq.update_ctx(jctx, w)
        tctx = treq.update_ctx(
            tctx, from_numpy_tree(with_island_axis(w), device="cpu"))
        assert_tree_equal(to_np(jctx), _island(tctx, 0), f"update{i}")
        fresh = treq.build_base_ctx(to_torch(base)[None])
        assert_tree_equal({k: v.numpy() for k, v in fresh.items()}, tctx,
                          f"fresh{i}")
    # the winners really moved stops
    assert not (np.array_equal(start["v"], np.asarray(jctx["v"]))
                and np.array_equal(start["c"], np.asarray(jctx["c"])))
