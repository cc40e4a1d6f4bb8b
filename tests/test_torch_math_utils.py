"""Rounding helpers, torch port vs the JAX package: the twin of
`tests/test_math_utils.py`. The host `rint` / `round_decimal` and the
tensor `rint_t` / `round_decimal_t` must give exactly what the JAX
package's `rint` / `rint_jnp` / `round_decimal` / `round_decimal_jnp`
give on the same inputs. Tolerance: none."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from greyjack_tpu.utils import math_utils as jmu
from greyjack_tpu_torch.utils import math_utils as tmu

torch.set_num_threads(1)


def test_rint_ties_toward_ceil():
    xs = [4.4, 4.6, 4.5, -2.5, -2.6, 0.0, -0.5, 1e15 + 0.5]
    assert [tmu.rint(x) for x in xs] == [jmu.rint(x) for x in xs]
    assert [tmu.rint(x) for x in xs[:6]] == [4.0, 5.0, 5.0, -2.0, -3.0, 0.0]


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_rint_t_matches_jnp(dtype):
    xs = np.concatenate([np.linspace(-10, 10, 401),  # many .x5 values
                         np.random.default_rng(0).normal(size=200) * 1e3]
                        ).astype(dtype)
    want = np.asarray(jmu.rint_jnp(jnp.asarray(xs)))
    got = tmu.rint_t(torch.from_numpy(xs)).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, np.array([jmu.rint(float(x)) for x in xs], dtype=dtype))


def test_round_decimal_truncates():
    cases = [(1.2345, 3), (1.9999, 3), (50778.123456, 3), (7.0, 0),
             (-3.14159, 2), (0.1 + 0.2, 1)]
    assert [tmu.round_decimal(v, p) for v, p in cases] \
        == [jmu.round_decimal(v, p) for v, p in cases]
    assert tmu.round_decimal(1.2345, 3) == 1.234
    assert tmu.round_decimal(1.9999, 3) == 1.999


@pytest.mark.parametrize("precision", [0, 1, 3, [3, 3, 1], [0, 0, 3]])
def test_round_decimal_t_matches_jnp(precision):
    rng = np.random.default_rng(1)
    width = len(precision) if isinstance(precision, list) else 1
    xs = np.abs(rng.normal(size=(200, width)) * 100)
    xs[:, -1] = rng.normal(size=200) * 5e4
    want = np.asarray(jmu.round_decimal_jnp(jnp.asarray(xs), precision))
    got = tmu.round_decimal_t(torch.from_numpy(xs), precision).numpy()
    np.testing.assert_array_equal(got, want)
    if not isinstance(precision, list):
        np.testing.assert_array_equal(
            got[:, 0], [jmu.round_decimal(float(x), precision)
                        for x in xs[:, 0]])


def test_true_div_equals_the_quotient():
    """`true_div` divides by a tensor: on the CPU it equals `/` and numpy's
    true division of the same values (on the card, where a Python divisor
    becomes a reciprocal product, `tests/test_torch_card_scores_cuda.py`
    holds it to the CPU's)."""
    x = np.arange(0, 5_000_000, 13, dtype=np.float64)
    got = tmu.true_div(torch.from_numpy(x), 1000.0)
    np.testing.assert_array_equal(got.numpy(), x / 1000.0)
    assert got.dtype == torch.float64
    # the reciprocal product the card would take differs for some values
    assert (x * (1.0 / 1000.0) != x / 1000.0).any()
