"""The helpers that apply and analyse deltas (`ops/moves.py` `apply_delta`,
`dedupe_delta`; `ops/segments.py` `nunique_delta`) against straightforward
O(K^2) forms kept here, at narrow widths (their unrolled / [K, K] forms)
and wide ones (sort and scatter forms), with duplicate positions and
invalid entries; and, at a whole-tour width, that the wide forms build no
[K, K] or [K, V] tensor. Every integer must be equal."""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from greyjack_tpu_torch import config
from greyjack_tpu_torch.ops import moves, segments

torch.set_num_threads(1)

WIDTHS = [1, 2, 8, 9, 16, 64, 301]


def plain_apply(base, delta):
    """Each valid entry written in order: later entries win."""
    out = base.clone()
    for i in range(base.shape[0]):
        for k in range(delta["positions"].shape[1]):
            if delta["valid"][i, k]:
                out[i, int(delta["positions"][i, k])] = delta["values"][i, k]
    return out


def plain_dedupe(delta):
    """bool: valid entries whose position no earlier valid entry holds."""
    pos, valid = delta["positions"], delta["valid"]
    k = pos.shape[-1]
    idx = torch.arange(k)
    eq = ((pos[..., :, None] == pos[..., None, :])
          & valid[..., :, None] & valid[..., None, :])
    return valid & ~torch.any(eq & (idx[None, :] < idx[:, None]), dim=-1)


def plain_nunique(counts, old_vals, new_vals, valid):
    """The change in distinct values, row by row on the host."""
    out = np.zeros(old_vals.shape[:-1], np.int32)
    for i, m in np.ndindex(*out.shape):
        hist = counts[i].clone().long()
        before = int((hist > 0).sum())
        for k in range(old_vals.shape[-1]):
            if valid[i, m, k]:
                hist[int(old_vals[i, m, k])] -= 1
        for k in range(new_vals.shape[-1]):
            if valid[i, m, k]:
                v = int(new_vals[i, m, k])
                if v < hist.shape[0]:
                    hist[v] += 1
        out[i, m] = int((hist > 0).sum()) - before
    return torch.from_numpy(out)


def _delta(rng, lead, k, n_pos):
    """Deltas with repeated positions (drawn from few positions) and about
    a quarter of the entries invalid."""
    return {"positions": torch.as_tensor(
                rng.integers(0, n_pos, size=lead + (k,)), dtype=torch.int32),
            "values": torch.as_tensor(
                rng.integers(1, 50, size=lead + (k,)), dtype=torch.float32),
            "valid": torch.as_tensor(rng.random(lead + (k,)) < 0.75)}


@pytest.mark.parametrize("k", WIDTHS)
def test_apply_delta_later_entries_win(k):
    rng = np.random.default_rng(k)
    v = 40
    for n_pos in (min(v, max(2, k // 3)), v):    # many repeats, then few
        delta = _delta(rng, (3,), k, n_pos)
        base = torch.as_tensor(rng.integers(1, 50, size=(3, v)),
                               dtype=torch.float32)
        got = moves.apply_delta(base, delta)
        assert got.dtype == base.dtype
        assert torch.equal(got, plain_apply(base, delta))
    none = {**delta, "valid": torch.zeros_like(delta["valid"])}
    assert torch.equal(moves.apply_delta(base, none), base)


@pytest.mark.parametrize("k", WIDTHS)
def test_dedupe_delta_keeps_the_first_of_each_position(k):
    rng = np.random.default_rng(100 + k)
    for lead in ((2,), (2, 5)):
        delta = _delta(rng, lead, k, max(2, k // 2))
        got = moves.dedupe_delta(delta)
        assert torch.equal(got["valid"], plain_dedupe(delta))
        assert got["positions"] is delta["positions"]


@pytest.mark.parametrize("k", WIDTHS)
def test_nunique_delta_counts_each_value_once(k):
    rng = np.random.default_rng(200 + k)
    l = 30
    counts = torch.as_tensor(rng.integers(0, 3, size=(2, l)),
                             dtype=torch.int32)
    # old values where the histogram has them, new ones anywhere, some
    # past the histogram (dropped)
    old = torch.as_tensor(rng.integers(0, l, size=(2, 4, k)),
                          dtype=torch.int32)
    counts = counts + torch.zeros_like(counts).scatter_add_(
        1, old.reshape(2, -1).long(), torch.ones_like(old.reshape(2, -1)))
    new = torch.as_tensor(rng.integers(0, l + 3, size=(2, 4, k)),
                          dtype=torch.int32)
    valid = torch.as_tensor(rng.random((2, 4, k)) < 0.75)
    got = segments.nunique_delta(counts, old, new, valid)
    assert got.dtype == torch.int32
    assert torch.equal(got, plain_nunique(counts, old, new, valid))


class _Shapes(TorchDispatchMode):
    """The element counts of every tensor an op returns."""

    def __init__(self):
        super().__init__()
        self.numels = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor):
                self.numels.append(t.numel())
        return out


def test_whole_tour_width_builds_no_quadratic_tensor():
    """A K = V = 2000 delta per island (a whole-tour winner): no tensor of
    K * K / 4 elements or more is made, where the narrow forms would make
    [K, K] and [K, V] ones."""
    k = v = 2000
    assert k > config.MAX_NARROW_DELTA
    rng = np.random.default_rng(5)
    delta = _delta(rng, (2,), k, v)
    base = torch.zeros((2, v), dtype=torch.float32)
    counts = torch.ones((2, v), dtype=torch.int32)
    with _Shapes() as seen:
        moves.apply_delta(base, delta)
        moves.dedupe_delta(delta)
        segments.nunique_delta(counts, delta["positions"][:, None],
                               delta["positions"][:, None].flip(-1),
                               delta["valid"][:, None])
    assert seen.numels and max(seen.numels) < k * k // 4


def test_tsp_whole_tour_winner_builds_no_quadratic_tensor():
    """The TSP model's own use of a whole-tour winner (K = N = 2000 rows):
    applying it to the population, updating the ctx and scoring it as a
    neighbour make no tensor of K * K / 4 elements or more."""
    from greyjack_tpu_torch.models.tsp import (CotwinBuilder,
                                               generate_uniform_instance)
    from greyjack_tpu_torch.models.tsp import cotwin_builder as tcb
    from greyjack_tpu_torch.score_calculation.score_requesters import (
        ScoreRequester)

    req = ScoreRequester(CotwinBuilder(True, False).build_cotwin(
        generate_uniform_instance(2001, seed=1, device="cpu"), False))
    base = req.variables_manager.initial_values[None].repeat(2, 1)
    k = base.shape[1]
    ctx = req.build_base_ctx(base)
    utils = req._delta_utils()
    delta = {"positions": torch.arange(k, dtype=torch.int32).repeat(2, 1),
             "values": base.flip(-1),
             "valid": torch.ones((2, k), dtype=torch.bool)}
    with _Shapes() as seen:
        moves.apply_delta(base, delta)
        req.update_ctx(ctx, delta)
        tcb.score_delta(ctx, {n: x[:, None] for n, x in delta.items()},
                        utils)
    assert seen.numels and max(seen.numels) < k * k // 4
