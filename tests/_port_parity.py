"""Shared helpers for the parity tests of the torch port against the JAX
package: build one instance in both packages, carry arrays across, and
compare trees leaf by leaf (values and dtypes)."""

import numpy as np
import torch

import jax

from greyjack_tpu.models.vrp import CotwinBuilder as JCotwinBuilder
from greyjack_tpu.models.vrp import generate_instance as j_generate
from greyjack_tpu.score_calculation.score_requesters import (
    ScoreRequester as JScoreRequester,
)
from greyjack_tpu_torch.models.vrp import CotwinBuilder as TCotwinBuilder
from greyjack_tpu_torch.models.vrp import generate_instance as t_generate
from greyjack_tpu_torch.score_calculation.score_requesters import (
    ScoreRequester as TScoreRequester,
)
from greyjack_tpu_torch.interop import from_numpy_tree

torch.set_num_threads(1)


def vrp_pair(tw, n=40, d=2, kveh=6, seed=3, greedy=False):
    """(jax_requester, torch_requester, jax_domain, torch_domain) for one
    synthetic instance built by both packages from the same seed."""
    jd = j_generate(n, d, kveh, seed=seed, time_windowed=tw)
    td = t_generate(n, d, kveh, seed=seed, time_windowed=tw)
    jreq = JScoreRequester(JCotwinBuilder(True, greedy).build_cotwin(jd, False))
    treq = TScoreRequester(TCotwinBuilder(True, greedy).build_cotwin(td, False))
    return jreq, treq, jd, td


def to_np(tree):
    return jax.tree.map(np.asarray, tree)


def to_torch(tree):
    """JAX arrays -> torch tensors (CPU), same keys and dtypes."""
    return from_numpy_tree(to_np(tree))


def with_island_axis(tree):
    """Add a leading island axis of size 1 to every leaf (JAX per-island
    state -> the port's batched layout)."""
    return jax.tree.map(lambda x: np.asarray(x)[None], to_np(tree))


def tabu_state_to_port(jstate):
    """A JAX TabuSearch state batched over islands by `jax.vmap` (leaves
    [I, ...]) as the port's island state: the same keys, shapes and dtypes,
    the sweep counters (`sweep_scored`, `sweep_nonconv`, `sweep_stall`)
    included when the JAX kernel runs the sweep path."""
    tree = to_np(jstate)
    if "sweep_scored" in tree:
        for key, dtype in (("sweep_scored", np.int64),
                           ("sweep_nonconv", np.int64),
                           ("sweep_stall", np.int32)):
            assert tree[key].dtype == dtype, (key, tree[key].dtype)
    return from_numpy_tree(tree)


def jax_sweep_targets(key, free, base_over, jcfg):
    """The target rows and validity JAX's `sweep.propose` draws from `key`
    for one island (`greyjack_tpu/models/vrp/sweep.py:717-726`)."""
    import jax.numpy as jnp

    free_list, free_count = free
    fc = free_count[jcfg.g_cust]
    lmax = jcfg.cust_group_lmax
    t = jcfg.targets
    keys_rnd = jax.random.uniform(key, (lmax,), jnp.float32) \
        + jnp.where(jnp.arange(lmax) < fc, 0.0, 2.0)
    order = jnp.argsort(keys_rnd)[:t]
    t_valid = (jnp.arange(t, dtype=jnp.int32) < fc) & ~base_over
    t_rows = jcfg.row_of_cust_slot[free_list[jcfg.g_cust][order]]
    return np.asarray(t_rows), np.asarray(t_valid)


def assert_leaf_equal(want, got, name=""):
    want = np.asarray(want)
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert want.dtype == got.dtype, f"{name}: dtype {got.dtype} != {want.dtype}"
    assert want.shape == got.shape, f"{name}: shape {got.shape} != {want.shape}"
    np.testing.assert_array_equal(got, want, err_msg=name)


def assert_tree_equal(want, got, prefix=""):
    if isinstance(want, dict):
        assert set(want) == set(got), f"{prefix}: keys {set(got) ^ set(want)}"
        for k in want:
            assert_tree_equal(want[k], got[k], f"{prefix}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(want) == len(got), prefix
        for i, (w, g) in enumerate(zip(want, got)):
            assert_tree_equal(w, g, f"{prefix}[{i}]")
    else:
        assert_leaf_equal(want, got, prefix)
