"""Variable descriptors and `VariablesManager`, torch port vs the JAX
package: the twin of `tests/test_variables.py`. Every case feeds the same
declarations and values to both packages and requires equal outputs,
including the manager's `semantic_groups_map`, `discrete_ids` and
`inverse_transform_float`. Tolerance: none."""

import numpy as np
import pytest
import torch

import jax

from greyjack_tpu.score_calculation.score_requesters import (
    VariablesManager as JVM)
from greyjack_tpu.variables import GJFloat as JFloat, GJInteger as JInteger
from greyjack_tpu_torch import config
from greyjack_tpu_torch.score_calculation.score_requesters import (
    VariablesManager as TVM)
from greyjack_tpu_torch.variables import GJFloat as TFloat, GJInteger as TInteger

torch.set_num_threads(1)

PKGS = {"jax": (JFloat, JInteger), "torch": (TFloat, TInteger)}


def _both(fn):
    """fn(GJFloat, GJInteger) evaluated with each package's descriptors."""
    return [fn(*PKGS[p]) for p in ("jax", "torch")]


def test_frozen_initial():
    got = _both(lambda F, I: I(1, -1, 1, True, None).get_initial_value())
    assert got == [1.0, 1.0]


def test_fix_clamps():
    def fn(F, I):
        x = I(1, -1, 1, False, None)
        f = F(1.0, -1.0, 1.0, False, None)
        return [x.fix(-100.0), x.fix(100.0), f.fix(-100.0), f.fix(100.0),
                x.fix(0.5), x.fix(-0.5)]
    want, got = _both(fn)
    assert got == want
    assert want[:4] == [-1.0, 1.0, -1.0, 1.0]


def test_inverse_transform_rounding():
    def fn(F, I):
        x = I(1, -10, 10, False, None)
        return [x.inverse_transform(v) for v in (4.4, 4.6, 4.5, -2.5)]
    want, got = _both(fn)
    assert got == want
    assert want[:2] == [4, 5]


def test_frozen_requires_initial():
    for _, I in PKGS.values():
        with pytest.raises(ValueError):
            I(None, 0, 5, True, None)


def test_default_semantic_group():
    assert _both(lambda F, I: I(None, 0, 5, False, None).semantic_groups) \
        == [["common"], ["common"]]


def _managers(decls):
    """(JAX manager, port manager on the CPU) of the same declarations."""
    return (JVM([make(*PKGS["jax"]) for make in decls]),
            TVM([make(*PKGS["torch"]) for make in decls], "cpu"))


def test_manager_semantic_groups_skip_frozen():
    jvm, tvm = _managers([
        lambda F, I: I(0, 0, 9, False, ["a", "common"]),
        lambda F, I: I(1, 0, 9, True, ["a", "common"]),  # frozen: excluded
        lambda F, I: F(None, 0.0, 1.0, False, ["b"]),
    ])
    assert tvm.semantic_groups_map == jvm.semantic_groups_map
    assert tvm.semantic_groups_map == {"a": [0], "common": [0], "b": [2]}
    assert tvm.discrete_ids == jvm.discrete_ids == [0, 1]
    assert tvm.semantic_group_keys == jvm.semantic_group_keys
    np.testing.assert_array_equal(tvm.group_members_np, jvm.group_members_np)
    np.testing.assert_array_equal(tvm.group_sizes_np, jvm.group_sizes_np)


def test_manager_without_discrete_ids():
    jvm, tvm = _managers([lambda F, I: F(None, 0.0, 1.0, False, None)] * 3)
    assert tvm.discrete_ids is None and jvm.discrete_ids is None


def test_manager_fix_all_and_sampling():
    decls = [lambda F, I: I(None, 0, 9, False, None),
             lambda F, I: F(None, -1.0, 1.0, False, None),
             lambda F, I: I(5, 0, 9, True, None)]
    jvm, tvm = _managers(decls)
    arr = tvm.sample_variables(torch.Generator().manual_seed(0), 64).numpy()
    assert arr.shape == (64, 3)
    assert ((arr[:, 0] >= 0) & (arr[:, 0] <= 9)).all()
    assert (arr[:, 0] == np.round(arr[:, 0])).all()
    assert ((arr[:, 1] >= -1.0) & (arr[:, 1] <= 1.0)).all()
    assert (arr[:, 2] == 5.0).all()

    rng = np.random.default_rng(3)
    wild = np.concatenate([np.array([[100.0, -7.0, 0.0], [3.4, 0.5, 1.0],
                                     [2.5, 0.25, 7.0], [-0.5, 1.5, 9.0]]),
                           rng.normal(scale=8.0, size=(32, 3))])
    for dtype in (np.float64, np.float32):
        x = wild.astype(dtype)
        for name in ("fix_all", "inverse_transform_float"):
            want = np.asarray(getattr(jvm, name)(x))
            got = getattr(tvm, name)(torch.from_numpy(x)).numpy()
            assert got.dtype == want.dtype, (name, dtype)
            np.testing.assert_array_equal(got, want, err_msg=name)
    fixed = tvm.fix_all(torch.from_numpy(wild[:2])).numpy()
    np.testing.assert_array_equal(fixed[0], [9.0, -1.0, 5.0])
    np.testing.assert_array_equal(fixed[1], [3.0, 0.5, 5.0])


def test_manager_reads_float_dtype_when_built():
    decl = [lambda F, I: F(None, -1.0, 1.0, False, None)]
    try:
        config.use_float64()
        tvm64 = TVM([decl[0](*PKGS["torch"])], "cpu")
        config.use_float32()
        tvm32 = TVM([decl[0](*PKGS["torch"])], "cpu")
    finally:
        config.use_float32()
    assert tvm64.float_dtype == torch.float64
    assert tvm64.lower_bounds.dtype == torch.float64
    assert tvm32.float_dtype == torch.float32
    assert tvm32.lower_bounds.dtype == torch.float32
    assert config.FLOAT_DTYPE == torch.float32


def test_inverse_transform_variables_match():
    decls = [lambda F, I: I(None, 0, 9, False, None),
             lambda F, I: F(None, -1.0, 1.0, False, None)]
    jvm, tvm = _managers(decls)
    row = np.array([4.5, 0.25])
    assert tvm.inverse_transform_variables(row) \
        == jvm.inverse_transform_variables(row)
    key = jax.random.key(0)
    jrow = np.asarray(jvm.sample_variables(key, 1)[0])
    assert tvm.inverse_transform_variables(jrow) \
        == jvm.inverse_transform_variables(jrow)
