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


def mixedint_pair(n_floats=4, n_ints=4, objective="rastrigin", lower=-5.12,
                  upper=5.12):
    """(jax_requester, torch_requester) of one mixed-int instance built by
    both packages (the port's on the CPU)."""
    from greyjack_tpu.models.mixedint import (DomainBuilder as JMIDomain,
                                              CotwinBuilder as JMICotwin)
    from greyjack_tpu_torch.models.mixedint import (
        DomainBuilder as TMIDomain, CotwinBuilder as TMICotwin)

    args = (n_floats, n_ints, lower, upper, objective)
    jd = JMIDomain(*args).build_domain_from_scratch()
    td = TMIDomain(*args, device="cpu").build_domain_from_scratch()
    return (JScoreRequester(JMICotwin().build_cotwin(jd, False)),
            TScoreRequester(TMICotwin().build_cotwin(td, False)))


def jax_lshade_noise(key, p, h, g_size, p_best_rate, jvm, jcfg, dtype):
    """The leaves the JAX LSHADE step draws from `key`
    (`greyjack_tpu/agents/lshade.py:95-196`) for one island, in the port's
    layout (torch, CPU, no island axis): `split(key, 12)`, the children's
    move noise split per child from ks[10] as `move_population` splits it,
    and the prune noise from `fold_in(key, 1337)`."""
    import jax.numpy as jnp

    v = jvm.variables_count
    ks = jax.random.split(key, 12)
    f64 = jnp.float64
    out = {
        "rid": jax.random.randint(ks[0], (p,), 0, h),
        "n_cr": jax.random.normal(ks[1], (p,), f64),
        "n_mp": jax.random.normal(ks[2], (p,), f64),
        "u_c": jax.random.uniform(ks[3], (p, 8), f64),
        "u_pb": jax.random.uniform(ks[4], (p,), f64, minval=1e-5,
                                   maxval=p_best_rate),
        "u_pid": jax.random.uniform(ks[5], (p,), f64),
        "u_r1": jax.random.uniform(ks[6], (p,), f64),
        "u_r2": jax.random.uniform(ks[7], (p,), f64),
        "u_branch": jax.random.uniform(ks[8], (p, 2), f64),
        "u_mask": jax.random.uniform(ks[9], (p, v), jnp.float32),
        "u_prune": jax.random.uniform(jax.random.fold_in(key, 1337),
                                      (h + p,), f64),
    }
    if g_size > 0:
        kg1, kg2 = jax.random.split(ks[11])
        out["cnt"] = jax.random.randint(kg1, (p,), 1, g_size + 1)
        out["gsel"] = jax.random.uniform(kg2, (p, v), jnp.float32)
    tree = from_numpy_tree(to_np(out), device="cpu")
    move = jax_population_noise([ks[10]], jax_move_noise, jvm, jcfg, dtype,
                                p)
    tree["move"] = {k: x[0] for k, x in move.items()}
    return tree


def stack_leaves(trees):
    """Per-island torch leaf trees -> one tree with a leading island
    axis."""
    if isinstance(trees[0], dict):
        return {k: stack_leaves([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _freeze(cotwin, group, col, rows):
    for r in rows:
        getattr(cotwin.planning_entities[group][r], col).frozen = True
    return cotwin


def tsp_pair(n=24, seed=3, greedy=True, exact=False, incremental=True,
             frozen_rows=()):
    """(jax_requester, torch_requester, jax_domain, torch_domain) of one
    uniform TSP instance built by both packages from the same seed (the
    port's on the CPU). `frozen_rows` pins those tour positions (frozen
    variables leave the semantic group, so the sweep's slot maps differ
    from the rows)."""
    from greyjack_tpu.models.tsp import (CotwinBuilder as JTSPCotwin,
                                         generate_uniform_instance as jgen)
    from greyjack_tpu_torch.models.tsp import (
        CotwinBuilder as TTSPCotwin, generate_uniform_instance as tgen)

    jd = jgen(n, seed=seed)
    td = tgen(n, seed=seed, device="cpu")
    args = (incremental, greedy, exact)
    jc = _freeze(JTSPCotwin(*args).build_cotwin(jd, False), "path_stops",
                 "locations_vec_id", frozen_rows)
    tc = _freeze(TTSPCotwin(*args).build_cotwin(td, False), "path_stops",
                 "locations_vec_id", frozen_rows)
    return JScoreRequester(jc), TScoreRequester(tc), jd, td


def perturbed_tours(jreq, n_isl=2, seed=7, n_moves=6):
    """f32[I, N] bases: the requester's initial (greedy) tour with a few
    seeded swaps per island, and a duplicated stop on odd islands."""
    rng = np.random.default_rng(seed)
    init = np.asarray(jreq.variables_manager.initial_values)
    out = []
    for i in range(n_isl):
        b = init.copy()
        for _ in range(n_moves):
            x, y = rng.integers(len(b), size=2)
            b[x], b[y] = b[y], b[x]
        if i % 2:
            b[3] = b[7]
        out.append(b)
    return np.stack(out).astype(np.float32)


def base_ctxs(jreq, treq, bases):
    """(per-island JAX ctxs, the port's batched ctx) of f[I, V] bases."""
    import jax.numpy as jnp

    return ([jreq.build_base_ctx(jnp.asarray(b)) for b in bases],
            treq.build_base_ctx(torch.from_numpy(bases)))


def nqueens_pair(n=16, seed=45, incremental=True):
    """(jax_requester, torch_requester, jax_board, torch_board) of one
    seeded N-Queens board built by both packages (the port's on the
    CPU)."""
    from greyjack_tpu.models.nqueens import (DomainBuilder as JNQDomain,
                                             CotwinBuilder as JNQCotwin)
    from greyjack_tpu_torch.models.nqueens import (
        DomainBuilder as TNQDomain, CotwinBuilder as TNQCotwin)

    jb = JNQDomain(n, seed).build_domain_from_scratch()
    tb = TNQDomain(n, seed, device="cpu").build_domain_from_scratch()
    return (JScoreRequester(JNQCotwin(incremental).build_cotwin(jb, False)),
            TScoreRequester(TNQCotwin(incremental).build_cotwin(tb, False)),
            jb, tb)


def jax_tsp_sweep_targets(key, free, jcfg):
    """The target rows and validity the JAX TSP `sweep.propose` draws from
    `key` for one island (`greyjack_tpu/models/tsp/sweep.py:245-252`)."""
    import jax.numpy as jnp

    free_list, free_count = free
    fc = free_count[jcfg.g0]
    lmax = jcfg.group_lmax
    t = jcfg.targets
    keys_rnd = jax.random.uniform(key, (lmax,), jnp.float32) \
        + jnp.where(jnp.arange(lmax) < fc, 0.0, 2.0)
    order = jnp.argsort(keys_rnd)[:t]
    t_valid = jnp.arange(t, dtype=jnp.int32) < fc
    t_rows = jcfg.row_of_slot[free_list[jcfg.g0][order]]
    return np.asarray(t_rows), np.asarray(t_valid)
