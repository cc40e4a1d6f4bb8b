"""The generic move samplers of the torch port vs the JAX package.

The deterministic bodies `do_move` (whole candidates) and `do_move_delta`
(delta form), fed the noise the JAX functions draw from the same keys
(`_port_parity.jax_move_noise` / `jax_delta_noise` mirror their key
splits), give the JAX outputs bit for bit: moved candidates, deltas and
tabu info, under each single move type, the default six-equal mix, a zero
and a unit mutation-rate multiplier, with tabu on. Tolerance: none — every
result is an integer, a bool or an f32 value compared exactly. Wide
`apply_delta` and `request_score_delta` at kd = 16 are held the same way.
The port's own draws are checked in distribution: move-type frequencies
against the thresholds, distinct and tabu-free positions, and uniform
scramble permutations."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from greyjack_tpu.ops import moves as jmoves, selection as jsel

from _port_parity import (vrp_pair, to_np, assert_leaf_equal,
                          jax_move_noise, jax_delta_noise,
                          jax_population_noise, jit_integer_stages)
from greyjack_tpu_torch.interop import from_numpy_tree
from greyjack_tpu_torch.ops import moves as tmoves, selection as tsel
from greyjack_tpu_torch.solver.solver import island_generators

_N_ISL, _P = 2, 24
_PROBAS = [[1.0, 0, 0, 0, 0, 0], [0, 1.0, 0, 0, 0, 0], [0, 0, 1.0, 0, 0, 0],
           [0, 0, 0, 1.0, 0, 0], [0, 0, 0, 0, 1.0, 0], [0, 0, 0, 0, 0, 1.0],
           None]
_SCRAMBLE = _PROBAS[3]


@pytest.fixture(scope="module")
def pair():
    jreq, treq, _, _ = vrp_pair(True, n=30, d=2, kveh=5)
    return jreq, treq


def _tabu_states(jcfg, seed, n_push=12):
    """Per-island JAX tabu states after random pushes, and the port's
    batched state holding the same rings."""
    rng = np.random.default_rng(seed)
    states = []
    for _ in range(_N_ISL):
        st = jcfg.init_tabu_state()
        for _ in range(n_push):
            g = int(rng.integers(0, jcfg.n_groups))
            pos = rng.integers(0, jcfg.max_group_size, size=3).astype(np.int32)
            st = jsel.tabu_push(st, g, jnp.asarray(pos), int(rng.integers(1, 4)))
        states.append(st)
    tstate = from_numpy_tree(
        {k: np.stack([np.asarray(s[k]) for s in states]) for k in states[0]},
        device="cpu")
    return states, tstate


def _bases(jvm, seed):
    keys = jax.random.split(jax.random.key(seed), _N_ISL)
    return [jvm.sample_variables(k, 1)[0] for k in keys]


def _configs(jreq, treq, probas, mult):
    jcfg = jmoves.MoverConfig(jreq.variables_manager, 0.2, mult, probas)
    tcfg = tmoves.MoverConfig(treq.variables_manager, 0.2, mult, probas)
    return jcfg, tcfg


def _compare_info(jinfo, tinfo):
    assert_leaf_equal(np.asarray(jinfo["positions"]).astype(np.int32),
                      tinfo["positions"], "info positions")
    assert_leaf_equal(np.asarray(jinfo["count"]).astype(np.int32),
                      tinfo["count"], "info count")
    # the JAX group id is int64 under x64, the port's int32
    np.testing.assert_array_equal(np.asarray(jinfo["group"]),
                                  tinfo["group"].numpy())


@pytest.mark.parametrize("mult", [None, 1.0])
@pytest.mark.parametrize("probas", _PROBAS)
def test_do_move_bit_equal(pair, probas, mult):
    jreq, treq = pair
    jvm, tvm = jreq.variables_manager, treq.variables_manager
    jcfg, tcfg = _configs(jreq, treq, probas, mult)
    jstates, tstate = _tabu_states(jcfg, 3)
    # enough scramble candidates that some window starts clamp
    n_cand = 256 if probas == _SCRAMBLE else _P
    bases = _bases(jvm, 5)
    keys = jax.random.split(jax.random.key(7), _N_ISL)
    jmoved, jinfo = [], []
    for i in range(_N_ISL):
        pop = jnp.broadcast_to(bases[i], (n_cand, bases[i].shape[0]))
        # mix the population so candidates differ
        pop = pop.at[1::2].set(jvm.sample_variables(keys[i], n_cand // 2))
        m, inf = jmoves.move_population(keys[i], pop, jvm, jcfg, jstates[i])
        jmoved.append((pop, m))
        jinfo.append(inf)
    noise = jax_population_noise(keys, jax_move_noise, jvm, jcfg,
                                 jnp.float32, n_cand)
    tpop = torch.from_numpy(np.stack([np.asarray(p) for p, _ in jmoved]))
    moved, info = tmoves.do_move(tpop, noise, tvm, tcfg,
                                 tcfg.tabu_masks(tstate))
    assert_leaf_equal(np.stack([np.asarray(m) for _, m in jmoved]), moved,
                      "moved")
    _compare_info({k: np.stack([np.asarray(x[k]) for x in jinfo])
                   for k in jinfo[0]}, info)
    assert (moved != tpop).any(), "no candidate moved"
    if probas == _SCRAMBLE:
        # some scramble windows start past lmax - 6: the window slice
        # clamps its start, as `dynamic_slice` does
        length = tcfg.group_sizes[noise["g"].long()]
        start = torch.floor(noise["u_start"] * torch.clamp(
            length - noise["k_scr"], min=1).float())
        assert ((start > tcfg.max_group_size - 6)
                & (length > noise["k_scr"])).any()


@pytest.mark.parametrize("mult", [None, 1.0])
@pytest.mark.parametrize("probas", _PROBAS)
def test_do_move_delta_bit_equal(pair, probas, mult):
    jreq, treq = pair
    jvm, tvm = jreq.variables_manager, treq.variables_manager
    jcfg, tcfg = _configs(jreq, treq, probas, mult)
    jstates, tstate = _tabu_states(jcfg, 9)
    bases = _bases(jvm, 11)
    keys = jax.random.split(jax.random.key(13), _N_ISL)
    want = []
    for i in range(_N_ISL):
        masks = jcfg.tabu_masks(jstates[i])
        ks = jax.random.split(keys[i], _P)
        want.append(jax.vmap(lambda k: jmoves.do_move_delta(
            k, bases[i], jvm, jcfg, masks))(ks))
    noise = jax_population_noise(
        keys, jax_delta_noise, jvm, jcfg, jnp.float32, _P)
    tbase = torch.from_numpy(np.stack([np.asarray(b) for b in bases]))
    delta, info = tmoves.do_move_delta(tbase, noise, tvm, tcfg,
                                       tcfg.tabu_masks(tstate))
    for k in ("positions", "values", "valid"):
        assert_leaf_equal(np.stack([np.asarray(w[0][k]) for w in want]),
                          delta[k], k)
    _compare_info({k: np.stack([np.asarray(w[1][k]) for w in want])
                   for k in want[0][1]}, info)
    assert delta["valid"].any()
    # the k_sel == 2 configurations take the distinct-pair selector
    assert ("u_a" in noise) == (tcfg.k_sel == 2)


def test_both_selectors_are_covered(pair):
    jreq, treq = pair
    ks = {tmoves.MoverConfig(treq.variables_manager, 0.2, m, p).k_sel
          for p in _PROBAS for m in (None, 1.0)}
    assert ks == {2, 8}


@pytest.mark.parametrize("seed", [0, 1])
def test_wide_apply_delta_bit_equal(pair, seed):
    _, treq = pair
    rng = np.random.default_rng(seed)
    v = treq.variables_manager.variables_count
    base = rng.random((3, v)).astype(np.float32)
    kd = 16
    # collisions: positions drawn from a small range
    delta = {"positions": rng.integers(0, 12, (3, kd)).astype(np.int32),
             "values": rng.random((3, kd)).astype(np.float32),
             "valid": rng.random((3, kd)) < 0.7}
    want = np.stack([np.asarray(jmoves.apply_delta(
        jnp.asarray(base[i]), {k: jnp.asarray(x[i]) for k, x in delta.items()}))
        for i in range(3)])
    got = tmoves.apply_delta(torch.from_numpy(base),
                             from_numpy_tree(delta, device="cpu"))
    assert_leaf_equal(want, got, "apply_delta")


def test_binomial_counts_match(pair):
    jreq, _ = pair
    jcfg = jmoves.MoverConfig(jreq.variables_manager, 0.2, 1.0, None)
    u = jax.random.uniform(jax.random.key(3), (5, 60), dtype=jnp.float32)
    g = jnp.asarray([0, 1, 0, 1, 1])
    want = jnp.sum(u < jcfg.group_rates[g][:, None].astype(jnp.float32),
                   axis=-1).astype(jnp.int32)
    tcfg = tmoves.MoverConfig(pair[1].variables_manager, 0.2, 1.0, None)
    got = tmoves.binomial_counts(torch.from_numpy(np.array(u)),
                                 tcfg.group_rates[torch.tensor([0, 1, 0, 1, 1])])
    assert_leaf_equal(want, got, "counts")


@pytest.fixture(scope="module")
def score_pair():
    mp = pytest.MonkeyPatch()
    jreq, treq, _, _ = vrp_pair(True, n=30, d=2, kveh=5)
    mp.delenv("GJ_PALLAS_INTERPRET", raising=False)
    jit_integer_stages(mp, [jreq])
    yield jreq, treq
    mp.undo()


def test_request_score_delta_kd16_bit_equal(score_pair):
    jreq, treq = score_pair
    jvm = jreq.variables_manager
    jcfg = jmoves.MoverConfig(jvm, 0.2, 1.0, None)
    assert jcfg.delta_width == 16
    bases = _bases(jvm, 17)
    keys = jax.random.split(jax.random.key(19), _N_ISL)
    jctx = [jreq.build_base_ctx(b) for b in bases]
    jd = [jmoves.move_population_delta(k, b, 32, jvm, jcfg,
                                       jcfg.init_tabu_state())[0]
          for k, b in zip(keys, bases)]
    tctx = from_numpy_tree({k: np.stack([np.asarray(c[k]) for c in jctx])
                            for k in jctx[0]}, device="cpu")
    tdeltas = from_numpy_tree({k: np.stack([np.asarray(d[k]) for d in jd])
                               for k in jd[0]}, device="cpu")
    assert treq.request_score_delta_ints(tctx, tdeltas) is None
    got = treq.request_score_delta(tctx, tdeltas)
    for i in range(_N_ISL):
        assert_leaf_equal(jreq.request_score_delta(jctx[i], jd[i]), got[i],
                          f"island {i}")
    assert not torch.all(got == got[:, :1])


# --- the port's draws, in distribution ---------------------------------------

def test_move_type_frequencies(pair):
    _, treq = pair
    tvm = treq.variables_manager
    probas = [0.1, 0.2, 0.3, 0.15, 0.15, 0.1]
    tcfg = tmoves.MoverConfig(tvm, 0.0, None, probas)
    gens = island_generators(3, 2, "cpu")
    noise = tmoves.draw_move_noise(gens, 4000, tvm, tcfg, torch.float32)
    mt = torch.sum(tcfg.thresholds < noise["u_move"][..., None], -1)
    freq = torch.bincount(mt.reshape(-1), minlength=6).double() / mt.numel()
    # 8,000 draws: 5 sigma of the largest share is under 0.026
    np.testing.assert_allclose(freq.numpy(), probas, atol=0.026)
    assert noise["k_scr"].min() == 3 and noise["k_scr"].max() == 6
    assert noise["g"].min() == 0 and noise["g"].max() == tcfg.n_groups - 1
    for name in ("u_start", "u_res"):
        x = noise[name]
        assert x.dtype == torch.float32 and (x >= 0).all() and (x < 1).all()
    assert torch.isfinite(noise["gumbel"]).all()


def test_selected_positions_distinct_in_range_and_tabu_free(pair):
    _, treq = pair
    tvm = treq.variables_manager
    tcfg = tmoves.MoverConfig(tvm, 0.2, 1.0, None)
    gens = island_generators(5, 2, "cpu")
    state = tcfg.init_tabu_state(2)
    # make slots 0..4 of group 0 tabu on island 0
    state = tsel.tabu_push(state, torch.tensor([0, 1]),
                           torch.tensor([[0, 1, 2, 3, 4], [0, 0, 0, 0, 0]],
                                        dtype=torch.int32),
                           torch.tensor([5, 0], dtype=torch.int32))
    masks = tcfg.tabu_masks(state)
    assert masks[0, 0, :5].all() and not masks[1].any()
    noise = tmoves.draw_move_noise(gens, 2000, tvm, tcfg, torch.float32)
    g = noise["g"].long()
    length = tcfg.group_sizes[g]
    sel = tsel.gumbel_topk_positions(noise["gumbel"], length, 8,
                                     tsel.tabu_mask_row(masks, g))
    s = torch.sort(sel, -1).values
    assert (s[..., 1:] != s[..., :-1]).all(), "positions repeat"
    assert (sel < length[..., None]).all() and (sel >= 0).all()
    on0 = g[0] == 0
    assert on0.any()
    assert not torch.isin(sel[0][on0], torch.arange(5)).any(), \
        "a tabu slot was chosen"
    # every free slot is reached
    assert len(torch.unique(sel[0][on0])) == int(length[0][on0][0]) - 5


def test_scramble_permutations_uniform():
    gens = island_generators(7, 1, "cpu")
    u = torch.rand((1, 12000, 6), generator=gens[0], dtype=torch.float64)
    g = tmoves.gumbel_f32(tmoves.uniform_f32(u))
    perm = tsel.random_permutation_positions(g, torch.full((1, 12000), 3))
    assert (perm[..., 3:] == torch.arange(3, 6)).all()
    codes = perm[0, :, 0] * 9 + perm[0, :, 1] * 3 + perm[0, :, 2]
    counts = torch.bincount(codes, minlength=27)
    counts = counts[counts > 0]
    assert len(counts) == 6
    # 2,000 expected each: 5 sigma is 204
    assert (counts - 2000).abs().max() < 204


def test_generic_sampler_runs_through_move_population_delta(pair):
    _, treq = pair
    tvm = treq.variables_manager
    tcfg = tmoves.MoverConfig(tvm, 0.2, None, None)
    assert not tcfg.narrow and tcfg.delta_width == 16
    gens = island_generators(9, 2, "cpu")
    base = torch.stack([tvm.sample_variables(g, 1)[0] for g in gens])
    delta, info = tmoves.move_population_delta(
        gens, base, 40, tvm, tcfg, tcfg.init_tabu_state(2))
    assert delta["positions"].shape == (2, 40, 16)
    assert info["positions"].shape == (2, 40, 2)
    applied = tmoves.apply_delta(base, {k: v[:, 0] for k, v in delta.items()})
    assert applied.shape == base.shape
