"""N-Queens model of the torch port vs the JAX package (<= 32 queens): the
seeded board, the plain score, the three-histogram delta ctx,
`score_delta`, `update_ctx` and `ctx_int_totals` must be bit-equal, dtypes
included (integer arrays against jitted JAX, the f64 rows against eager
JAX); and the `Solver.solve` twins of `tests/test_nqueens.py`'s solves
must reach zero conflicts (TabuSearch) and no worse than the shuffled
board (GeneticAlgorithm). Tolerance: none."""

import inspect

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from greyjack_tpu.models.nqueens import cotwin_builder as jcb

from _port_parity import (nqueens_pair, assert_leaf_equal, assert_tree_equal,
                          stack_states)
from greyjack_tpu_torch.agents import GeneticAlgorithm, TabuSearch
from greyjack_tpu_torch.agents.termination_strategies import (ScoreLimit,
                                                              StepsLimit)
from greyjack_tpu_torch.models import nqueens
from greyjack_tpu_torch.models.nqueens import cotwin_builder as tcb
from greyjack_tpu_torch.ops import moves
from greyjack_tpu_torch.score_calculation.scores import SimpleScore
from greyjack_tpu_torch.solver import (Solver, SolverLoggingLevels,
                                       SolverMetrics)

torch.set_num_threads(1)

_SILENT = SolverLoggingLevels.Silent


def oracle_scores(rows_batch, n):
    """The reference's `all_different` (`plain_score_calculator.rs:26-67`)."""
    cols = np.arange(n)
    return np.array([float((n - len(set(r.tolist())))
                           + (n - len(set((cols + r).tolist())))
                           + (n - len(set((cols - r).tolist()))))
                     for r in rows_batch])


def test_board_and_plain_score_bit_equal():
    n = 32
    jreq, treq, jb, tb = nqueens_pair(n, 45)
    assert [(q.row_id, q.column_id) for q in jb.queens] \
        == [(q.row_id, q.column_id) for q in tb.queens]
    assert jb.conflict_count() == tb.conflict_count() and str(jb) == str(tb)
    rng = np.random.default_rng(1234)
    pop = rng.integers(0, n, size=(64, n)).astype(np.float32)
    want = np.asarray(jreq.request_score_plain(jnp.asarray(pop)))
    got = treq.request_score_plain(torch.from_numpy(pop))
    assert_leaf_equal(want, got, "scores")
    np.testing.assert_array_equal(got[:, 0].numpy(),
                                  oracle_scores(pop.astype(np.int64), n))


def _bases(n, n_isl=2, seed=3):
    rng = np.random.default_rng(seed)
    out = [rng.permutation(n) for _ in range(n_isl)]
    out[1][2] = out[1][5]
    return np.stack(out).astype(np.float32)


def _deltas(rng, n, n_isl, m, k):
    """Swap-shaped deltas [I, M, K] (distinct positions), some entries
    invalid, one neighbour with no valid entry."""
    pos = np.argsort(rng.random((n_isl, m, n)), axis=-1)[..., :k]
    val = rng.integers(0, n, size=(n_isl, m, k)).astype(np.float32)
    valid = rng.random((n_isl, m, k)) < 0.85
    valid[:, 0] = False
    return {"positions": pos.astype(np.int32), "values": val,
            "valid": valid}


@pytest.mark.parametrize("k", [2, 8])
def test_delta_kernels_bit_equal(k):
    n = 24
    jreq, treq, _, _ = nqueens_pair(n, 45)
    bases = _bases(n)
    jctx = [jreq.build_base_ctx(jnp.asarray(b)) for b in bases]
    tctx = treq.build_base_ctx(torch.from_numpy(bases))
    assert_tree_equal(stack_states(jctx), tctx, "ctx")
    ju, tu = jreq._delta_utils(), treq._delta_utils()
    assert_leaf_equal(np.stack([np.asarray(jcb.ctx_int_totals(c, ju))
                                for c in jctx]),
                      tcb.ctx_int_totals(tctx, tu), "ctx_int_totals")
    m = 20
    d = _deltas(np.random.default_rng(k), n, 2, m, k)
    want = np.stack([np.stack([np.asarray(jcb.score_delta(
        jctx[i], {kk: jnp.asarray(x[i, j]) for kk, x in d.items()}, ju))
        for j in range(m)]) for i in range(2)])
    td = {kk: torch.from_numpy(x) for kk, x in d.items()}
    got = tcb.score_delta(tctx, td, tu)
    assert_leaf_equal(want, got, "score_delta")
    for i in range(2):
        patched = moves.apply_delta(torch.from_numpy(bases[i:i + 1]).expand(
            m, -1), {kk: x[i] for kk, x in td.items()})
        assert torch.equal(treq.request_score_plain(patched), got[i])

    up = jax.jit(lambda c, dd: jcb.update_ctx(c, dd, ju))
    for j in (0, 3):             # no valid entry, then a real move
        want = stack_states([up(jctx[i], {kk: jnp.asarray(x[i, j])
                                          for kk, x in d.items()})
                             for i in range(2)])
        one = {kk: x[:, j] for kk, x in td.items()}
        got = tcb.update_ctx(tctx, one, tu)
        assert_tree_equal(want, got, f"update_ctx {j}")
        assert_tree_equal(got, treq.build_base_ctx(
            moves.apply_delta(torch.from_numpy(bases), one)), "rebuilt")


def test_entry_points_default_to_the_card():
    assert inspect.signature(nqueens.DomainBuilder).parameters[
        "device"].default == "cuda"
    board = nqueens.DomainBuilder(8, 1, device="cpu").build_domain_from_scratch()
    cot = nqueens.CotwinBuilder(True).build_cotwin(board, False)
    assert cot.score_calculator.device.type == "cpu"
    default = nqueens.DomainBuilder(8, 1).build_domain_from_scratch()
    assert default.device.type == "cuda"


def test_solve_to_zero_tabu_search():
    """Twin of `tests/test_nqueens.py::test_solve_to_zero_tabu_search`: the
    delta path (no f64 ctx score: the model registers only its integer
    totals), run to ScoreLimit(0)."""
    db = nqueens.DomainBuilder(16, 45, device="cpu")
    agent = TabuSearch(20, 0.0, True, None, [0.0, 1.0, 0.0, 0.0, 0.0, 0.0],
                       10, ScoreLimit(SimpleScore(0.0)))
    metrics = SolverMetrics()
    sol = Solver.solve(db, nqueens.CotwinBuilder(True), agent, n_jobs=2,
                       logging_level=_SILENT, seed=7, metrics=metrics)
    assert {r["kernel_path"] for r in metrics.records} == {"delta"}
    assert db.build_from_solution(sol).conflict_count() == 0
    assert sol[1] == {"simple_value": 0.0}


def test_genetic_algorithm_improves():
    """Twin of `tests/test_nqueens.py::test_genetic_algorithm_improves`."""
    db = nqueens.DomainBuilder(12, 45, device="cpu")
    agent = GeneticAlgorithm(16, 0.5, 0.2, 0.0, 1.0, None, 0.1, 5,
                             StepsLimit(30))
    metrics = SolverMetrics()
    sol = Solver.solve(db, nqueens.CotwinBuilder(True), agent, n_jobs=2,
                       logging_level=_SILENT, seed=3, metrics=metrics)
    assert {r["kernel_path"] for r in metrics.records} == {"plain"}
    board0 = db.build_domain_from_scratch().conflict_count()
    assert sol[1]["simple_value"] <= board0
    assert sol[1]["simple_value"] == db.build_from_solution(
        sol).conflict_count()
