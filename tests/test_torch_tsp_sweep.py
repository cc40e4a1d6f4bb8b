"""TSP sweep neighbourhood of the torch port vs the JAX package (n <= 36):
`SweepConfig`, the four candidate families (change, swap, 2-opt reversal,
or-opt insertion), the deterministic half of `propose` fed the targets JAX
drew, and `exact_score_row` must be bit-equal, dtypes included, with and
without tabu masks and with a frozen stop. Two islands run as one batch in
the port and one by one in the JAX package. The integer arrays are
compared against jitted JAX, the f64 rows against eager JAX. Tolerance:
none."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from greyjack_tpu.models.tsp import sweep as jsweep
from greyjack_tpu.ops import moves as jmoves, selection as jsel

from _port_parity import (tsp_pair, assert_leaf_equal, assert_tree_equal,
                          jax_tsp_sweep_targets, stack_states,
                          perturbed_tours, base_ctxs)
from greyjack_tpu_torch.interop import from_numpy_tree
from greyjack_tpu_torch.models.tsp import sweep as tsweep
from greyjack_tpu_torch.ops import moves as tmoves, selection as tsel

torch.set_num_threads(1)

_N = 30                    # locations: 29 tour rows
_ROWS = _N - 1
_ISL = 2
_PROBAS = [0.0, 0.2, 0.2, 0.2, 0.2, 0.2]
_STUB = np.iinfo(np.int32).max


def test_sweep_config_matches():
    jreq, treq, _, _ = tsp_pair(_N, frozen_rows=(4,))
    assert jsweep.eligible(jreq._delta_utils())
    assert tsweep.eligible(treq._delta_utils())
    assert treq.supports_sweep and treq.sweep_module is tsweep
    for targets, window in ((12, None), (64, None), (8, 6)):
        jc = jsweep.SweepConfig(jreq, targets, window)
        tc = tsweep.SweepConfig(treq, targets, window)
        for attr in ("targets", "window", "n_rows", "g0", "group_lmax",
                     "kd"):
            assert getattr(jc, attr) == getattr(tc, attr), attr
        for attr in ("var_ids", "row_of_slot", "slot_of_row", "slot_valid",
                     "dm", "dmT"):
            assert_leaf_equal(getattr(jc, attr), getattr(tc, attr), attr)
        for rate in (0.0, 0.5):
            assert (jc.conservative_moves_per_step(jreq._delta_utils(), rate)
                    == tc.conservative_moves_per_step(treq._delta_utils(),
                                                      rate))
    # the frozen stop has no slot; the default is the JAX package's
    assert int(tc.slot_of_row[4]) == -1
    tc = tsweep.SweepConfig(treq)
    assert (tc.targets, tc.kd) == (min(64, _ROWS), _ROWS)
    with pytest.raises(ValueError):
        tsweep.SweepConfig(treq, 0)


def _targets(rng, t):
    t_rows = np.stack([rng.permutation(_ROWS)[:t] for _ in range(_ISL)]
                      ).astype(np.int32)
    t_valid = rng.random((_ISL, t)) < 0.8
    return t_rows, t_valid


@pytest.mark.parametrize("tabu,window", [(False, None), (True, None),
                                         (True, 6)])
def test_score_candidates_bit_equal(tabu, window):
    jreq, treq, _, _ = tsp_pair(_N)
    jctx, tctx = base_ctxs(jreq, treq, perturbed_tours(jreq))
    jc = jsweep.SweepConfig(jreq, _ROWS, window)
    tc = tsweep.SweepConfig(treq, _ROWS, window)
    rng = np.random.default_rng(3)
    t_rows, t_valid = _targets(rng, _ROWS)
    row_tabu = rng.random((_ISL, _ROWS)) < (0.2 if tabu else 0.0)
    ju = jreq._delta_utils()
    fn = jax.jit(lambda c, r, v, m: jsweep.score_candidates(c, r, v, m, jc,
                                                            ju))
    want = stack_states([fn(jctx[i], jnp.asarray(t_rows[i]),
                            jnp.asarray(t_valid[i]), jnp.asarray(row_tabu[i]))
                         for i in range(_ISL)])
    got = tsweep.score_candidates(
        tctx, torch.from_numpy(t_rows), torch.from_numpy(t_valid),
        torch.from_numpy(row_tabu), tc, treq._delta_utils())
    assert_tree_equal(want, got, "families")
    for fam in "acri":
        assert want[f"{fam}_valid"].any(), fam
    if window:
        assert not want["r_valid"].all(axis=(0, 1)).any()


def _tabu_states(jcfg, n_push=4):
    states = []
    for i in range(_ISL):
        st = jcfg.init_tabu_state()
        rng = np.random.default_rng(50 + i)
        for _ in range(n_push):
            pos = rng.integers(0, _ROWS - 1, size=2).astype(np.int32)
            st = jsel.tabu_push(st, jnp.int32(0), jnp.asarray(pos),
                                jnp.int32(2))
        states.append(st)
    return states


@pytest.mark.parametrize("case", ["no-tabu", "tabu", "tabu-frozen"])
def test_propose_from_jax_targets_bit_equal(case):
    frozen = (4,) if case == "tabu-frozen" else ()
    rate = 0.0 if case == "no-tabu" else 0.3
    jreq, treq, _, _ = tsp_pair(_N, frozen_rows=frozen)
    jctx, tctx = base_ctxs(jreq, treq, perturbed_tours(jreq))
    ju, tu = jreq._delta_utils(), treq._delta_utils()
    jc = jsweep.SweepConfig(jreq, 10)
    tc = tsweep.SweepConfig(treq, 10)
    jm = jmoves.MoverConfig(jreq.variables_manager, rate, None, _PROBAS)
    tm = tmoves.MoverConfig(treq.variables_manager, rate, None, _PROBAS)
    jtabu = (_tabu_states(jm) if jm.use_tabu
             else [jm.init_tabu_state() for _ in range(_ISL)])
    keys = jax.random.split(jax.random.key(4), _ISL)
    prop = jax.jit(lambda k, c, f, m: jsweep.propose(k, c, f, m, jc, ju))
    want, rows = [], []
    for i in range(_ISL):
        free = jm.tabu_free(jtabu[i])
        masks = jm.tabu_masks(jtabu[i]) if jm.use_tabu else None
        want.append(prop(keys[i], jctx[i], free, masks))
        rows.append(jax_tsp_sweep_targets(keys[i], free, jc))
    want = stack_states(want)
    t_rows = torch.from_numpy(np.stack([r[0] for r in rows]))
    t_valid = torch.from_numpy(np.stack([r[1] for r in rows]))
    ttabu = from_numpy_tree(stack_states(jtabu), device="cpu")
    row_tabu = tsweep.tabu_rows(tm.tabu_masks(ttabu) if tm.use_tabu else None,
                                tc, _ISL)
    assert row_tabu.any() == tm.use_tabu
    got = tsweep.propose_from_targets(tctx, t_rows, t_valid, row_tabu, tc, tu)
    assert_tree_equal(want, got, "propose")
    assert (want[1][:, 0] != _STUB).all() and want[3]["n_scored"].min() > 0
    if frozen:
        assert 4 not in t_rows.tolist()[0] + t_rows.tolist()[1]


def _long_move_bases(jreq):
    """Island 0: the greedy tour with positions 3..12 reversed (a 2-opt
    reversal restores it); island 1: the city at position 2 moved to sit
    after position 15 (an or-opt insertion restores it)."""
    init = np.asarray(jreq.variables_manager.initial_values)
    b0 = init.copy()
    b0[3:13] = b0[3:13][::-1]
    b1 = list(init.copy())
    b1.insert(15, b1.pop(2))
    return np.stack([b0, np.asarray(b1)]).astype(np.float32)


def _jax_propose_all(jreq, jctx, free_count):
    """JAX `propose` per island with every row a target (in the order its
    sampler draws them) and no tabu, the rows and validity it drew, and
    the config. `free_count` 0 marks every target invalid."""
    ju = jreq._delta_utils()
    jc = jsweep.SweepConfig(jreq, _ROWS)
    lmax = jc.group_lmax
    free = (jnp.arange(lmax, dtype=jnp.int32)[None],
            jnp.asarray([free_count], jnp.int32))
    prop = jax.jit(lambda k, c: jsweep.propose(k, c, free, None, jc, ju))
    keys = jax.random.split(jax.random.key(8), _ISL)
    want = stack_states([prop(keys[i], jctx[i]) for i in range(_ISL)])
    rows = [jax_tsp_sweep_targets(keys[i], free, jc) for i in range(_ISL)]
    return (want, torch.from_numpy(np.stack([r[0] for r in rows])),
            torch.from_numpy(np.stack([r[1] for r in rows])))


def test_long_winners_decode_exact_and_bit_equal():
    """Reversal and insertion winners over every row as a target: bit-equal
    to JAX, and each winner delta applied to its base gives the greedy
    tour back, whose exact integer totals are the base's plus `exact`."""
    jreq, treq, _, _ = tsp_pair(_N)
    bases = _long_move_bases(jreq)
    jctx, tctx = base_ctxs(jreq, treq, bases)
    want, t_rows, t_valid = _jax_propose_all(jreq, jctx, _ROWS)
    tc = tsweep.SweepConfig(treq, _ROWS)
    got = tsweep.propose_from_targets(
        tctx, t_rows, t_valid, torch.zeros((_ISL, _ROWS), dtype=torch.bool),
        tc, treq._delta_utils())
    assert_tree_equal(want, got, "propose")
    delta, exact = got[0], got[1]
    nvalid = delta["valid"].sum(-1)
    assert (nvalid > 2).all(), nvalid        # both winners are long moves
    seg = torch.from_numpy(bases[0, 3:13].copy())
    assert torch.equal(delta["values"][0, :10], seg.flip(0))  # a reversal
    assert int(nvalid[1]) in (13, 14)        # the insertion's span
    patched = tmoves.apply_delta(torch.from_numpy(bases), delta)
    after = treq.ctx_int_totals(treq.build_base_ctx(patched))
    before = treq.ctx_int_totals(tctx)
    assert torch.equal(after - before, exact.to(torch.int64))
    np.testing.assert_array_equal(
        patched.numpy(), np.asarray(jreq.variables_manager.initial_values)
        [None].repeat(_ISL, 0))


def test_no_valid_candidate_is_stubbed():
    jreq, treq, _, _ = tsp_pair(_N)
    jctx, tctx = base_ctxs(jreq, treq, perturbed_tours(jreq))
    want, t_rows, t_valid = _jax_propose_all(jreq, jctx, 0)
    assert not t_valid.any()
    tc = tsweep.SweepConfig(treq, _ROWS)
    got = tsweep.propose_from_targets(
        tctx, t_rows, t_valid, torch.zeros((_ISL, _ROWS), dtype=torch.bool),
        tc, treq._delta_utils())
    assert_tree_equal(want, got, "stubbed")
    assert (got[1] == _STUB).all() and not got[0]["valid"].any()
    row = tsweep.exact_score_row(tctx, got[1], treq._delta_utils())
    assert (row == np.finfo(np.float64).max - 1.0).all()


def test_exact_score_row_matches_eager_jax():
    jreq, treq, _, _ = tsp_pair(_N)
    jctx, tctx = base_ctxs(jreq, treq, perturbed_tours(jreq))
    exact = np.array([[0, -123457], [_STUB, 7]], np.int32)
    want = np.stack([np.asarray(jsweep.exact_score_row(
        jctx[i], jnp.asarray(exact[i]), jreq._delta_utils()))
        for i in range(_ISL)])
    got = tsweep.exact_score_row(tctx, torch.from_numpy(exact),
                                 treq._delta_utils())
    assert_leaf_equal(want, got, "exact_score_row")
    assert want[1, 0] == np.finfo(np.float64).max - 1.0


def test_sample_targets_contract():
    """The port draws its own targets (streams differ from jax.random):
    distinct tabu-free rows, valid up to the free count, never a frozen
    stop."""
    from greyjack_tpu_torch.solver.solver import island_generators

    _, treq, _, _ = tsp_pair(_N, frozen_rows=(4,))
    tc = tsweep.SweepConfig(treq, 12)
    tm = tmoves.MoverConfig(treq.variables_manager, 0.3, None, _PROBAS)
    tabu = tsel.tabu_push(tm.init_tabu_state(_ISL),
                          torch.tensor([0, 0], dtype=torch.int32),
                          torch.tensor([[0, 3], [5, 6]], dtype=torch.int32),
                          torch.tensor([2, 2], dtype=torch.int32))
    free = tm.tabu_free(tabu)
    bases = torch.from_numpy(perturbed_tours(tsp_pair(_N)[0]))
    ctx = treq.build_base_ctx(bases)
    t_rows, t_valid = tsweep.sample_targets(
        island_generators(1, _ISL, "cpu"), ctx, free, tc)
    assert t_rows.shape == (_ISL, 12) and t_rows.dtype == torch.int32
    assert t_valid.all()
    tabu_row = tsweep.tabu_rows(tm.tabu_masks(tabu), tc, _ISL)
    for i in range(_ISL):
        assert len(set(t_rows[i].tolist())) == 12
        assert not tabu_row[i, t_rows[i].long()].any()
        assert 4 not in t_rows[i].tolist()


def test_sweep_island_run_improves():
    """Twin of `tests/test_sweep_tsp.py::test_tsp_sweep_island_run_improves`:
    the runner's global best equals a plain rescore and is no worse than
    the start."""
    from greyjack_tpu_torch.agents import TabuSearch
    from greyjack_tpu_torch.agents.termination_strategies import StepsLimit
    from greyjack_tpu_torch.parallel import IslandRunner
    from greyjack_tpu_torch.solver.solver import island_generators

    _, treq, _, _ = tsp_pair(36, seed=11)
    agent = TabuSearch(64, 0.2, True, None, [0.5, 0.5, 0, 0, 0, 0], 5,
                       StepsLimit(100), sweep=True, sweep_targets=8)
    kernel = agent.build_kernel(treq, None)
    assert kernel.path == "sweep"
    runner = IslandRunner(kernel, 2, 5)
    gens = island_generators(1, 2, "cpu")
    state = runner.init(gens)
    init = state["islands"]["scores"][0, 0].clone()
    alive = torch.ones(2, dtype=torch.bool)
    for _ in range(6):
        state = runner.run_chunk(state, gens, alive, {}, 5)
    g = state["global_score"]
    assert torch.equal(g, treq.request_score_plain(
        state["global_values"][None])[0])
    assert tuple(g.tolist()) <= tuple(init.tolist())
    assert int(state["islands"]["sweep_scored"].sum()) > 0
