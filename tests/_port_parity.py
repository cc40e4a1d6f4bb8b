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


def vrp_pair(tw, n=40, d=2, kveh=6, seed=3, greedy=False, span=100.0):
    """(jax_requester, torch_requester, jax_domain, torch_domain) for one
    synthetic instance built by both packages from the same seed. A large
    `span` (coordinate range) makes an instance whose route metrics need
    i64 accumulation, so the fused delta kernel and the sweep turn it
    down."""
    jd = j_generate(n, d, kveh, seed=seed, time_windowed=tw, span=span)
    td = t_generate(n, d, kveh, seed=seed, time_windowed=tw, span=span,
                    device="cpu")
    jreq = JScoreRequester(JCotwinBuilder(True, greedy).build_cotwin(jd, False))
    treq = TScoreRequester(TCotwinBuilder(True, greedy).build_cotwin(td, False))
    return jreq, treq, jd, td


def to_np(tree):
    return jax.tree.map(np.asarray, tree)


def to_torch(tree):
    """JAX arrays -> torch tensors (CPU), same keys and dtypes."""
    return from_numpy_tree(to_np(tree), device="cpu")


def with_island_axis(tree):
    """Add a leading island axis of size 1 to every leaf (JAX per-island
    state -> the port's batched layout)."""
    return jax.tree.map(lambda x: np.asarray(x)[None], to_np(tree))


_STATE_DTYPES = {
    ("sweep_scored",): np.int64,
    ("sweep_nonconv",): np.int64,
    ("sweep_stall",): np.int32,
    ("temperature",): np.float64,
    ("late", "buf"): np.float64,
    ("late", "count"): np.int32,
    ("late", "head"): np.int32,
}


def tabu_state_to_port(jstate):
    """A JAX local-search state (TabuSearch, LateAcceptance or
    SimulatedAnnealing) batched over islands by `jax.vmap` (leaves
    [I, ...]) as the port's island state: the same keys, shapes and dtypes,
    including the sweep counters (`sweep_scored`, `sweep_nonconv`,
    `sweep_stall`), the LateAcceptance ring (`late`) and the SA
    `temperature` where the JAX kernel carries them."""
    tree = to_np(jstate)
    for path, dtype in _STATE_DTYPES.items():
        leaf = tree
        for key in path:
            leaf = leaf.get(key) if isinstance(leaf, dict) else None
        if leaf is not None:
            assert leaf.dtype == dtype, (path, leaf.dtype)
    return from_numpy_tree(tree, device="cpu")


def jit_integer_stages(mp, jreqs):
    """Make the JAX package's integer-only delta stages run jitted under
    eager steps: `cotwin_builder._delta_parts`, `sweep.propose` and the
    requesters' `update_ctx`. Their outputs are integers (and integral
    floats), so jit changes no bit, and a step's eager run compiles far
    fewer ops; the f64 score assembly and acceptance around them stay
    eager, where `x / 1000.0` is not rewritten to `x * 0.001`. One jitted
    program per instance (keyed by its distance matrix) and sweep config.
    `mp` is a pytest MonkeyPatch."""
    from greyjack_tpu.models.vrp import cotwin_builder as jcb
    from greyjack_tpu.models.vrp import sweep as jsweep

    cache = {}

    def jitted(fn, key, *static):
        if key not in cache:
            cache[key] = jax.jit(lambda *a: fn(*a, *static))
        return cache[key]

    parts = jcb._delta_parts
    propose = jsweep.propose
    mp.setattr(jcb, "_delta_parts", lambda c, d, u: jitted(
        parts, ("parts", id(u["dm_flat_milli"])), u)(c, d))
    mp.setattr(jsweep, "propose", lambda key, c, free, masks, cfg, u: jitted(
        propose, ("propose", id(cfg), id(u["dm_flat_milli"])), cfg, u)(
            key, c, free, masks))
    for jreq in jreqs:
        mp.setattr(jreq, "update_ctx", jax.jit(jreq.update_ctx))


def step_keys(seed, i, n_isl):
    """Per-island JAX keys of step `i`."""
    return jax.random.split(jax.random.fold_in(jax.random.key(seed), i),
                            n_isl)


def warm_jax_state(jk, n_isl, seed, warm_steps, extras=None):
    """A JAX local-search kernel's island state (leaves [I, ...]) after
    `warm_steps` jitted steps of every island. It is only an input to the
    compared step, so jit's last-bit f64 differences do not matter here."""
    import jax.numpy as jnp

    st = jax.jit(jax.vmap(jk.init_state))(
        jax.random.split(jax.random.key(seed), n_isl))
    step = jax.jit(jax.vmap(jk.step))
    for i in range(warm_steps):
        ex = dict(extras or {})
        if jk.self_gating:
            ex["_active"] = jnp.ones((n_isl,), bool)
        if jk.prestep is not None:
            ex.update(jk.prestep(st))
        st = step(step_keys(seed + 1, i, n_isl), st, ex)
    return st


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


def _jax_group_leaves(k_group, k_count, jvm, jcfg):
    import jax.numpy as jnp

    g = jax.random.randint(k_group, (), 0, max(1, jcfg.n_groups))
    if jcfg.rates_zero:
        c_raw = jnp.zeros((), jnp.int32)
    else:
        c_raw = jnp.sum(
            jax.random.uniform(k_count, (jvm.variables_count,), jnp.float32)
            < jcfg.group_rates[g].astype(jnp.float32)).astype(jnp.int32)
    return {"g": g, "c_raw": c_raw}


def jax_move_noise(key, jvm, jcfg, dtype):
    """The noise leaves the JAX package's `do_move` draws from `key`, in
    the order of its key split (`greyjack_tpu/ops/moves.py:198-234`)."""
    import jax.numpy as jnp
    from greyjack_tpu import config as jconfig

    (k_move, k_group, k_count, k_sel, k_len, k_start, k_perm, k_res) = \
        jax.random.split(key, 8)
    out = {"u_move": jax.random.uniform(k_move, (), dtype=jnp.float64)}
    out.update(_jax_group_leaves(k_group, k_count, jvm, jcfg))
    out["gumbel"] = jax.random.gumbel(k_sel, (jcfg.max_group_size,),
                                      dtype=jnp.float32)
    out["k_scr"] = jax.random.randint(k_len, (), jconfig.SCRAMBLE_MIN,
                                      jconfig.SCRAMBLE_MAX + 1)
    out["u_start"] = jax.random.uniform(k_start, (), dtype=jnp.float32)
    out["perm_gumbel"] = jax.random.gumbel(k_perm, (jconfig.SCRAMBLE_MAX,),
                                           dtype=jnp.float32)
    out["u_res"] = jax.random.uniform(k_res, (jconfig.MAX_MOVE_SIZE,),
                                      dtype=dtype)
    return out


def jax_delta_noise(key, jvm, jcfg, dtype):
    """The noise leaves the JAX package's `do_move_delta` draws from `key`
    (`greyjack_tpu/ops/moves.py:346-486`), for the enabled moves only."""
    import jax.numpy as jnp
    from greyjack_tpu import config as jconfig

    enabled = set(jcfg.enabled)
    kd = jcfg.delta_width
    (k_move, k_group, k_count, k_sel, k_len, k_start, k_perm, k_res) = \
        jax.random.split(key, 8)
    out = {}
    if len(jcfg.enabled) > 1:
        out["u_move"] = jax.random.uniform(k_move, (), dtype=jnp.float64)
    out.update(_jax_group_leaves(k_group, k_count, jvm, jcfg))
    if jcfg.k_sel == 2:
        ka, kb = jax.random.split(k_sel)
        shape = (4,) if jcfg.use_tabu else ()
        out["u_a"] = jax.random.uniform(ka, shape, dtype=jnp.float32
                                        ).reshape(-1)
        out["u_b"] = jax.random.uniform(kb, shape, dtype=jnp.float32
                                        ).reshape(-1)
    else:
        out["gumbel"] = jax.random.gumbel(k_sel, (jcfg.max_group_size,),
                                          dtype=jnp.float32)
    if 3 in enabled:
        out["k_scr"] = jax.random.randint(k_len, (), jconfig.SCRAMBLE_MIN,
                                          jconfig.SCRAMBLE_MAX + 1)
        out["u_start"] = jax.random.uniform(k_start, (), dtype=jnp.float32)
        out["perm_gumbel"] = jax.random.gumbel(
            jax.random.fold_in(k_perm, 1), (jconfig.SCRAMBLE_MAX,),
            dtype=jnp.float32)
    if {4, 5} & enabled:
        k_off, k_sign = jax.random.split(k_perm)
        out["off"] = jax.random.randint(k_off, (), 1, kd)
        out["sign"] = jax.random.bernoulli(k_sign, 0.5)
    if 0 in enabled:
        out["u_res"] = jax.random.uniform(k_res, (kd,), dtype=dtype)
    return out


def jax_population_noise(keys_by_island, fn, jvm, jcfg, dtype, n):
    """Port-layout noise leaves [I, n, ...] (torch, CPU) of `fn`
    (`jax_move_noise` / `jax_delta_noise`) for each island's key, split
    into n per-candidate keys as `move_population(_delta)` splits them."""
    per_isl = []
    for key in keys_by_island:
        keys = jax.random.split(key, n)
        per_isl.append(jax.vmap(lambda k: fn(k, jvm, jcfg, dtype))(keys))
    tree = {k: np.stack([np.asarray(t[k]) for t in per_isl])
            for k in per_isl[0]}
    return from_numpy_tree(tree, device="cpu")


def plain_pair(tw=True, n=30, d=2, kveh=5, seed=3, greedy=False):
    """(jax_requester, torch_requester) of one instance whose cotwins have
    no delta kernels (`CotwinBuilder(False, greedy)`), so every agent takes
    its plain, full-rescore branch."""
    jd = j_generate(n, d, kveh, seed=seed, time_windowed=tw)
    td = t_generate(n, d, kveh, seed=seed, time_windowed=tw, device="cpu")
    jreq = JScoreRequester(JCotwinBuilder(False, greedy).build_cotwin(jd,
                                                                      False))
    treq = TScoreRequester(TCotwinBuilder(False, greedy).build_cotwin(td,
                                                                      False))
    return jreq, treq


def stack_states(states):
    """Per-island JAX states -> one numpy tree with a leading island axis."""
    return jax.tree.map(lambda *xs: np.stack([np.asarray(x) for x in xs]),
                        *states)
