"""Move configuration, entity tabu and delta helpers of the torch port vs
the JAX package, and the narrow delta sampler's distributional contract
(the two packages' random streams differ, so the sampler is checked for
valid masks, tabu-free slots, bounds and move mix, not draw for draw)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from greyjack_tpu.ops import moves as jmoves, selection as jsel

from _port_parity import vrp_pair, to_np, assert_leaf_equal, assert_tree_equal
from greyjack_tpu_torch.interop import from_numpy_tree
from greyjack_tpu_torch.ops import moves as tmoves, selection as tsel
from greyjack_tpu_torch.solver.solver import island_generators

_PROBAS = [
    [0.5, 0.5, 0, 0, 0, 0],
    [1.0, 0, 0, 0, 0, 0],
    [0, 1.0, 0, 0, 0, 0],
    [0.2, 0.2, 0.2, 0.2, 0.1, 0.1],
    None,
]


@pytest.fixture(scope="module")
def pair():
    jreq, treq, _, _ = vrp_pair(True)
    return jreq, treq


@pytest.mark.parametrize("probas", _PROBAS)
@pytest.mark.parametrize("mult", [None, 1.0])
def test_mover_config_geometry(pair, probas, mult):
    jreq, treq = pair
    jc = jmoves.MoverConfig(jreq.variables_manager, 0.2, mult, probas)
    tc = tmoves.MoverConfig(treq.variables_manager, 0.2, mult, probas)
    for attr in ("enabled", "rates_zero", "delta_width", "k_sel", "use_tabu",
                 "n_groups", "max_group_size"):
        assert getattr(jc, attr) == getattr(tc, attr), attr
    for attr in ("thresholds", "tabu_sizes", "group_rates", "group_sizes"):
        assert_leaf_equal(getattr(jc, attr), getattr(tc, attr), attr)
    narrow = (jc.rates_zero and set(jc.enabled) <= {0, 1}
              and jc.delta_width == 2 and jc.k_sel == 2)
    assert tc.narrow == narrow
    assert_leaf_equal(jc.init_tabu_state()["ring"][None],
                      tc.init_tabu_state(1)["ring"], "ring")


def _pushed_states(jc, rng, n_push=40):
    """A sequence of JAX tabu states after random pushes (wrap-around
    included) plus the pushes themselves."""
    st = jc.init_tabu_state()
    out = []
    for _ in range(n_push):
        g = int(rng.integers(0, jc.n_groups))
        pos = rng.integers(0, jc.max_group_size, size=2).astype(np.int32)
        cnt = int(rng.integers(0, 3))
        st = jsel.tabu_push(st, jnp.int32(g), jnp.asarray(pos), jnp.int32(cnt))
        out.append((g, pos, cnt, to_np(st)))
    return out


def test_tabu_push_free_masks(pair):
    jreq, treq = pair
    jc = jmoves.MoverConfig(jreq.variables_manager, 0.2, None, _PROBAS[0])
    tc = tmoves.MoverConfig(treq.variables_manager, 0.2, None, _PROBAS[0])
    rng = np.random.default_rng(2)
    tst = tc.init_tabu_state(1)
    for g, pos, cnt, jst in _pushed_states(jc, rng):
        tst = tsel.tabu_push(tst, torch.tensor([g], dtype=torch.int32),
                             torch.from_numpy(pos)[None],
                             torch.tensor([cnt], dtype=torch.int32))
        assert_tree_equal({k: v[None] for k, v in jst.items()}, tst)
    jfl, jcnt = jc.tabu_free(jst)
    tfl, tcnt = tc.tabu_free(tst)
    assert_leaf_equal(np.asarray(jfl)[None], tfl, "free_list")
    assert_leaf_equal(np.asarray(jcnt)[None], tcnt, "free_count")
    assert_leaf_equal(np.asarray(jc.tabu_masks(jst))[None], tc.tabu_masks(tst),
                      "masks")


def test_tabu_free_island_batched(pair):
    jreq, treq = pair
    jc = jmoves.MoverConfig(jreq.variables_manager, 0.3, None, _PROBAS[0])
    tc = tmoves.MoverConfig(treq.variables_manager, 0.3, None, _PROBAS[0])
    states = [_pushed_states(jc, np.random.default_rng(s), 25)[-1][3]
              for s in range(3)]
    jb = jax.tree.map(lambda *x: np.stack(x), *states)
    jfl, jcnt = jc.tabu_free(jax.tree.map(jnp.asarray, jb))
    tfl, tcnt = tc.tabu_free(from_numpy_tree(jb, device="cpu"))
    assert_leaf_equal(jfl, tfl, "free_list")
    assert_leaf_equal(jcnt, tcnt, "free_count")


@pytest.mark.parametrize("probas", [_PROBAS[0], _PROBAS[2]])
def test_delta_helpers(pair, probas):
    jreq, treq = pair
    vm = jreq.variables_manager
    jc = jmoves.MoverConfig(vm, 0.2, None, probas)
    key = jax.random.key(8)
    base = vm.sample_variables(key, 1)[0]
    deltas, info = jmoves.move_population_delta(
        jax.random.fold_in(key, 1), base, 64, vm, jc, jc.init_tabu_state())
    # force a few duplicate positions so dedupe has work to do
    pos = np.asarray(deltas["positions"]).copy()
    pos[::5, 1] = pos[::5, 0]
    deltas = {**deltas, "positions": jnp.asarray(pos)}
    tdeltas = from_numpy_tree(to_np(deltas), device="cpu")
    assert_tree_equal(to_np(jax.vmap(jmoves.dedupe_delta)(deltas)),
                      tmoves.dedupe_delta(tdeltas))
    idx = np.array([0, 17, 63, 5], np.int32)
    for i in idx:
        jw = jmoves.take_one(deltas, jnp.int32(i))
        tw = tmoves.take_one({k: v[None] for k, v in tdeltas.items()},
                             torch.tensor([i]))
        assert_tree_equal(to_np(jw), {k: v[0] for k, v in tw.items()})
        jrow = jmoves.apply_delta(base, jw)
        trow = tmoves.apply_delta(
            from_numpy_tree(to_np(base), device="cpu")[None], tw)
        assert_leaf_equal(jrow, trow[0], "apply_delta")
    tinfo = from_numpy_tree(to_np(info), device="cpu")
    tst = tmoves.update_tabu_from_info(
        tmoves.MoverConfig(treq.variables_manager, 0.2, None, probas)
        .init_tabu_state(1),
        {k: v[None] for k, v in tinfo.items()}, torch.tensor([17]),
        torch.tensor([True]))
    jst = jmoves.update_tabu_from_info(jc.init_tabu_state(), info,
                                       jnp.int32(17), jnp.bool_(True))
    assert_tree_equal({k: np.asarray(v)[None] for k, v in jst.items()}, tst)


def test_narrow_sampler_distribution(pair):
    _, treq = pair
    vm = treq.variables_manager
    tc = tmoves.MoverConfig(vm, 0.2, None, _PROBAS[0])
    assert tc.narrow
    # two islands with different tabu rings
    tst = tc.init_tabu_state(2)
    for i, g in enumerate((0, 2, 1, 2)):
        tst = tsel.tabu_push(
            tst, torch.tensor([g, (g + 1) % 3], dtype=torch.int32),
            torch.tensor([[i, i + 5], [2 * i, 2 * i + 1]], dtype=torch.int32),
            torch.tensor([2, 2], dtype=torch.int32))
    base = torch.stack([vm.initial_values, vm.initial_values])
    base = vm.fix_all(base + 0.0)
    gens = island_generators(3, 2, "cpu")
    n = 4096
    free = tc.tabu_free(tst)
    deltas, info = tmoves.move_population_delta(gens, base, n, vm, tc, tst,
                                                free)
    pos, val, valid = deltas["positions"], deltas["values"], deltas["valid"]
    assert pos.shape == (2, n, 2) and val.dtype == torch.float32
    is_swap = info["count"] == 2
    # both move types occur at about their configured rates
    assert abs(is_swap.float().mean().item() - 0.5) < 0.05
    # change: one valid entry; swap: two, carrying each other's values
    assert torch.equal(valid[..., 0], torch.ones_like(valid[..., 0]))
    assert torch.equal(valid[..., 1], is_swap)
    cand = torch.gather(base, 1, pos.reshape(2, -1).long()).reshape(2, n, 2)
    lo = vm.lower_bounds[pos.long()]
    hi = vm.upper_bounds[pos.long()]
    # a swap on the common group may carry a vehicle id into a customer
    # variable: values are clamped into the target's bounds
    swapped = torch.clamp(cand.flip(-1), lo, hi)
    assert torch.equal(val[is_swap], swapped[is_swap])
    # positions are members of the drawn group at tabu-free slots
    members = vm.group_members.long()
    g = info["group"].long()
    slots = info["positions"].long()
    assert torch.equal(pos.long(), members[g[..., None], slots])
    tabu = tc.tabu_masks(tst)                                 # [2, G, L]
    isl = torch.arange(2)[:, None, None]
    assert not tabu[isl, g[..., None], slots].any()
    assert (slots[..., 0] != slots[..., 1]).all()
    # change values: integral and inside the variable's bounds
    ch = ~is_swap
    v0 = val[..., 0][ch]
    assert torch.equal(v0, torch.round(v0))
    assert (v0 >= lo[..., 0][ch]).all() and (v0 <= hi[..., 0][ch]).all()
    # every group is drawn
    assert set(g.unique().tolist()) == {0, 1, 2}
