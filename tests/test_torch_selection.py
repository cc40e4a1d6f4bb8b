"""The port's position selectors and lexicographic sort vs the JAX
package, fed the same noise: Gumbel top-k with tabu penalties and ties
(equal Gumbels, the -1e9 penalty that rounds tabu entries together in
f32, the -inf of out-of-range slots), the distinct-pair draw with and
without its tabu retries, scramble permutations, the per-group tabu masks,
and the stable multi-key score sort with tied rows. Tolerance: none — all
results are integer indices or exact copies of f64 rows."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from greyjack_tpu.ops import lexico as jlex, selection as jsel

from _port_parity import assert_leaf_equal
from greyjack_tpu_torch.ops import lexico as tlex, selection as tsel

torch.set_num_threads(1)


def _tied_gumbels(rng, shape):
    """Gumbel-like f32 noise with many exact ties (rounded to halves)."""
    return (np.round(rng.gumbel(size=shape) * 2) / 2).astype(np.float32)


@pytest.mark.parametrize("with_tabu", [False, True])
@pytest.mark.parametrize("max_len,k_max", [(12, 8), (5, 8), (40, 2)])
def test_gumbel_topk_positions_ties_and_tabu(monkeypatch, with_tabu,
                                             max_len, k_max):
    rng = np.random.default_rng(max_len + k_max)
    n = 64
    g = _tied_gumbels(rng, (n, max_len))
    limits = rng.integers(0, max_len + 2, n)
    tabu = rng.random((n, max_len)) < 0.4
    want = []
    for i in range(n):
        monkeypatch.setattr(jax.random, "gumbel",
                            lambda key, shape, dtype, _g=g[i]: jnp.asarray(_g))
        want.append(np.asarray(jsel.gumbel_topk_positions(
            jax.random.key(0), jnp.int32(limits[i]), k_max,
            jnp.asarray(tabu[i]) if with_tabu else None, max_len)))
    monkeypatch.undo()
    got = tsel.gumbel_topk_positions(
        torch.from_numpy(g), torch.from_numpy(limits),
        k_max, torch.from_numpy(tabu) if with_tabu else None)
    assert_leaf_equal(np.stack(want), got, "topk")


def test_topk_first_orders_ties_by_index():
    score = torch.tensor([[1.0, 3.0, 3.0, -float("inf"), 3.0, -0.0, 0.0,
                           -float("inf")]])
    assert tsel.topk_first(score, 8).tolist() == [[1, 2, 4, 0, 6, 5, 3, 7]]


@pytest.mark.parametrize("with_tabu", [False, True])
def test_sample_distinct_pair_bit_equal(with_tabu):
    rng = np.random.default_rng(5)
    n_isl, n, g_count, lmax = 2, 48, 3, 10
    masks = rng.random((n_isl, g_count, lmax)) < 0.5
    masks[:, 2] = True          # an exhausted group: the last draw is kept
    groups = rng.integers(0, g_count, (n_isl, n))
    limits = rng.integers(0, lmax + 1, (n_isl, n))
    keys = jax.random.split(jax.random.key(7), n_isl * n)
    shape = (4,) if with_tabu else ()
    want, ua, ub = [], [], []
    for j, key in enumerate(keys):
        i, p = divmod(j, n)
        ka, kb = jax.random.split(key)
        ua.append(np.asarray(jax.random.uniform(ka, shape, jnp.float32)
                             ).reshape(-1))
        ub.append(np.asarray(jax.random.uniform(kb, shape, jnp.float32)
                             ).reshape(-1))
        want.append(np.asarray(jsel.sample_distinct_pair(
            key, jnp.int32(limits[i, p]),
            jnp.asarray(masks[i]) if with_tabu else None,
            jnp.int32(groups[i, p]))))
    got = tsel.sample_distinct_pair(
        torch.from_numpy(np.stack(ua).reshape(n_isl, n, -1)),
        torch.from_numpy(np.stack(ub).reshape(n_isl, n, -1)),
        torch.from_numpy(limits),
        torch.from_numpy(masks) if with_tabu else None,
        torch.from_numpy(groups))
    assert_leaf_equal(np.stack(want).reshape(n_isl, n, 2), got, "pair")
    ok = limits > 1
    assert (got[..., 0] != got[..., 1])[torch.from_numpy(ok)].all()


def test_random_permutation_positions_bit_equal(monkeypatch):
    rng = np.random.default_rng(11)
    n, k_max = 80, 6
    g = _tied_gumbels(rng, (n, k_max))
    counts = rng.integers(0, k_max + 1, n)
    want = []
    for i in range(n):
        monkeypatch.setattr(jax.random, "gumbel",
                            lambda key, shape, dtype, _g=g[i]: jnp.asarray(_g))
        want.append(np.asarray(jsel.random_permutation_positions(
            jax.random.key(0), k_max, jnp.int32(counts[i]))))
    monkeypatch.undo()
    got = tsel.random_permutation_positions(torch.from_numpy(g),
                                            torch.from_numpy(counts))
    assert_leaf_equal(np.stack(want), got, "perm")


def test_tabu_mask_for_group_and_row():
    rng = np.random.default_rng(3)
    n_isl, g_count, cap, lmax = 2, 3, 6, 9
    sizes = np.asarray([2, 4, 6], np.int32)
    states, tstate = [], None
    rings = rng.integers(-1, lmax, (n_isl, g_count, cap)).astype(np.int32)
    cursors = rng.integers(0, cap, (n_isl, g_count)).astype(np.int32)
    tstate = {"ring": torch.from_numpy(rings),
              "cursor": torch.from_numpy(cursors)}
    groups = np.asarray([2, 1])
    got = tsel.tabu_mask_for_group(tstate, torch.from_numpy(groups),
                                   torch.from_numpy(sizes), lmax)
    for i in range(n_isl):
        js = {"ring": jnp.asarray(rings[i]), "cursor": jnp.asarray(cursors[i])}
        want = jsel.tabu_mask_for_group(js, groups[i], jnp.asarray(sizes),
                                        lmax)
        assert_leaf_equal(want, got[i], f"mask {i}")
        jmasks = jsel.tabu_masks_all(js, jnp.asarray(sizes), lmax)
        row = tsel.tabu_mask_row(
            tsel.tabu_masks_all(tstate, torch.from_numpy(sizes), lmax),
            torch.tensor([[0, 1, 2], [2, 1, 0]]))
        for j, gi in enumerate([[0, 1, 2], [2, 1, 0]][i]):
            assert_leaf_equal(jsel.tabu_mask_row(jmasks, gi), row[i, j],
                              f"row {i} {j}")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lex_sort_scores_with_ties(seed):
    rng = np.random.default_rng(seed)
    n_isl, n, s, v = 3, 40, 3, 5
    # few distinct values per column: many tied rows and partial ties
    scores = rng.integers(0, 3, (n_isl, n, s)).astype(np.float64)
    scores[0, :, 0] = 0.0
    payload = rng.random((n_isl, n, v)).astype(np.float32)
    got_s, got_p = tlex.lex_sort_scores_with(torch.from_numpy(scores),
                                             torch.from_numpy(payload))
    for i in range(n_isl):
        ws, wp = jlex.lex_sort_scores_with(jnp.asarray(scores[i]),
                                           jnp.asarray(payload[i]))
        assert_leaf_equal(ws, got_s[i], f"scores {i}")
        assert_leaf_equal(wp, got_p[i], f"payload {i}")
        assert_leaf_equal(jlex.lex_sort_order(jnp.asarray(scores[i])
                                              ).astype(np.int64),
                          tlex.lex_sort_order(torch.from_numpy(scores[i])),
                          f"order {i}")
