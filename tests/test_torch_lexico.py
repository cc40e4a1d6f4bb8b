"""Lexicographic ops of the torch port vs the JAX package, on rows with
ties (the lowest index must win)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from greyjack_tpu.ops import lexico as jlex
from greyjack_tpu_torch.ops import lexico as tlex

torch.set_num_threads(1)


def _tied_rows(rng, n, dtype):
    # few distinct values per column -> many ties, including full-row ties
    rows = rng.integers(0, 3, size=(n, 3)).astype(dtype)
    rows[n // 2] = rows[n // 3]
    return rows


@pytest.mark.parametrize("dtype", [np.float64, np.int32])
def test_lex_argmin_ties(dtype):
    rng = np.random.default_rng(7)
    for _ in range(20):
        rows = _tied_rows(rng, 17, dtype)
        want = int(jlex.lex_argmin(jnp.asarray(rows)))
        got = int(tlex.lex_argmin(torch.from_numpy(rows)))
        assert got == want
        # the winner is the FIRST of the minimal rows
        order = sorted(range(len(rows)), key=lambda i: (tuple(rows[i]), i))
        assert got == order[0]


def test_lex_argmin_batched_matches_per_row():
    rng = np.random.default_rng(3)
    rows = rng.integers(-2, 2, size=(4, 9, 3)).astype(np.int32)
    got = tlex.lex_argmin(torch.from_numpy(rows)).numpy()
    want = [int(jlex.lex_argmin(jnp.asarray(r))) for r in rows]
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("fn", ["lex_less", "lex_leq"])
def test_lex_compare(fn):
    rng = np.random.default_rng(11)
    a = rng.integers(0, 2, size=(64, 3)).astype(np.float64)
    b = rng.integers(0, 2, size=(64, 3)).astype(np.float64)
    want = np.asarray(getattr(jlex, fn)(jnp.asarray(a), jnp.asarray(b)))
    got = getattr(tlex, fn)(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(got, want)


def test_stub_row():
    np.testing.assert_array_equal(tlex.stub_score_row(3).numpy(),
                                  np.asarray(jlex.stub_score_row(3)))
