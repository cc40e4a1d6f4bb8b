"""Checkpoint / resume, profile capture and replanning through the port's
`Solver.solve` on the CPU.

The twin of `tests/test_checkpoint.py` (its three tests, on the VRP, since
the port has no N-Queens model yet), plus the port's own guarantee: a solve
stopped after a checkpoint and resumed from the file gives the final state
and solution of the uninterrupted solve, bit for bit. `profile_dir` writes
a trace file and leaves the result unchanged; the replanning flow of
`examples/vrp_example.py:53-61` keeps frozen stops in place."""

import os

import numpy as np
import pytest
import torch

from greyjack_tpu_torch.agents import LSHADE, TabuSearch
from greyjack_tpu_torch.agents.base import make_score_fn
from greyjack_tpu_torch.agents.termination_strategies import StepsLimit
from greyjack_tpu_torch.models.mixedint import (CotwinBuilder as MICotwin,
                                                DomainBuilder as MIDomain)
from greyjack_tpu_torch.models.vrp import (CotwinBuilder, DomainBuilder,
                                           generate_instance)
from greyjack_tpu_torch.score_calculation.score_requesters import (
    ScoreRequester)
from greyjack_tpu_torch.solver import (InitialSolution, Solver,
                                       SolverLoggingLevels, SolverMetrics)
from greyjack_tpu_torch.solver.checkpoint import load_checkpoint

torch.set_num_threads(1)

_SILENT = SolverLoggingLevels.Silent


def _db(n=24):
    return DomainBuilder.from_generator(
        lambda: generate_instance(n, 2, 5, seed=4, time_windowed=True,
                                  device="cpu"))


def _agent(steps, probas=(0.5, 0.5, 0, 0, 0, 0)):
    return TabuSearch(32, 0.2, True, None, list(probas), 5, StepsLimit(steps))


def _score(sol):
    return [sol[1]["hard_score"], sol[1]["medium_score"],
            sol[1]["soft_score"]]


def test_save_restore_roundtrip(tmp_path):
    ckpt = str(tmp_path / "solve.ckpt")
    Solver.solve(_db(), CotwinBuilder(True, True), _agent(14), n_jobs=2,
                 logging_level=_SILENT, seed=11, checkpoint_path=ckpt,
                 checkpoint_frequency=1)
    loaded = load_checkpoint(ckpt)
    # final checkpoint: both islands done, chunk counter advanced, meta
    assert not loaded["alive"].any()
    assert loaded["chunk_id"] >= 2
    assert loaded["meta"] == {"n_jobs": 2, "seed": 11}
    assert all(s.is_accomplish() for s in loaded["strategies"])
    assert "global_values" in loaded["state"]
    assert isinstance(loaded["state"]["islands"]["population"], np.ndarray)
    assert len(loaded["generators"]) == 2
    # written atomically: no temporary file is left beside it
    assert os.listdir(tmp_path) == ["solve.ckpt"]


def test_resume_is_deterministic(tmp_path):
    """Two resumes from the same checkpoint with a fresh step budget give
    the same solution: the island tree, generators, tabu rings and chunk
    counter all live in the checkpoint."""
    ckpt = str(tmp_path / "mid.ckpt")
    db, cb = _db(), CotwinBuilder(True, True)
    Solver.solve(db, cb, _agent(14), n_jobs=2, logging_level=_SILENT,
                 seed=23, checkpoint_path=ckpt, checkpoint_frequency=1)

    def resume():
        loaded = load_checkpoint(ckpt)
        loaded["strategies"] = [StepsLimit(14) for _ in range(2)]
        loaded["alive"] = np.ones(2, dtype=bool)
        return Solver.solve(db, cb, _agent(14), n_jobs=2,
                            logging_level=_SILENT, resume_from=loaded)

    assert resume() == resume()


def test_resume_never_regresses(tmp_path):
    ckpt = str(tmp_path / "mid.ckpt")
    db, cb = _db(30), CotwinBuilder(True, True)
    Solver.solve(db, cb, _agent(14), n_jobs=2, logging_level=_SILENT,
                 seed=5, checkpoint_path=ckpt, checkpoint_frequency=1)
    loaded = load_checkpoint(ckpt)
    ckpt_score = loaded["state"]["global_score"].tolist()
    loaded["strategies"] = [StepsLimit(24) for _ in range(2)]
    loaded["alive"] = np.ones(2, dtype=bool)
    sol = Solver.solve(db, cb, _agent(24), n_jobs=2, logging_level=_SILENT,
                       resume_from=loaded)
    assert _score(sol) <= ckpt_score


class _Stop(Exception):
    pass


class _StopAfter:
    """An observer that stops the solve (as a kill would) when the metrics
    of chunk `chunk` land, before that chunk's checkpoint is written."""

    def __init__(self, chunk):
        self.chunk = chunk

    def update(self, solution):
        pass

    def update_metrics(self, record):
        if record["chunk"] == self.chunk:
            raise _Stop


@pytest.mark.parametrize("case", ["ts-int-delta", "lshade-mixedint"])
def test_resumed_solve_equals_uninterrupted(tmp_path, case):
    if case == "ts-int-delta":
        db, cb = _db(), CotwinBuilder(True, True)

        def agent():
            return _agent(29)
    else:
        db = MIDomain(3, 3, -5.12, 5.12, "rastrigin", device="cpu")
        cb = MICotwin()

        def agent():
            return LSHADE(12, 8, 0.2, 0.5, 1, 0.5, 0.5, 0.5, 0.0, None,
                          None, 0.25, 5, StepsLimit(29))
    kw = dict(n_jobs=3, logging_level=_SILENT, seed=9)
    full = SolverMetrics()
    want = Solver.solve(db, cb, agent(), metrics=full, **kw)
    ckpt = str(tmp_path / "kill.ckpt")
    with pytest.raises(_Stop):
        Solver.solve(db, cb, agent(), checkpoint_path=ckpt,
                     checkpoint_frequency=1, metrics=SolverMetrics(),
                     observers=[_StopAfter(3)], **kw)
    assert load_checkpoint(ckpt)["chunk_id"] == 3
    resumed = SolverMetrics()
    got = Solver.solve(db, cb, agent(), resume_from=ckpt, metrics=resumed,
                       **kw)
    assert got == want
    assert [r["global_best"] for r in resumed.records] \
        == [r["global_best"] for r in full.records[3:]]
    assert resumed.records[0]["chunk"] == 3


def test_profile_dir_writes_a_trace(tmp_path):
    out = tmp_path / "prof"
    kw = dict(n_jobs=2, logging_level=_SILENT, seed=3)
    plain = Solver.solve(_db(), CotwinBuilder(True, True), _agent(29), **kw)
    profiled = Solver.solve(_db(), CotwinBuilder(True, True), _agent(29),
                            profile_dir=str(out), **kw)
    assert profiled == plain
    files = os.listdir(out)
    assert files == ["trace_chunks_2-4.json"]
    assert os.path.getsize(out / files[0]) > 0


def test_replanning_keeps_frozen_stops():
    """`examples/vrp_example.py:53-61`: solve, rebuild the domain from the
    solution, freeze vehicle 0's customers, solve again from
    `InitialSolution.from_domain`: the frozen stops keep their values and
    the returned score equals a plain rescore."""
    db, cb = _db(30), CotwinBuilder(True, True)
    sol = Solver.solve(db, cb, _agent(9), n_jobs=2, score_precision=[0, 0, 3],
                       logging_level=_SILENT, seed=1)
    domain = db.build_from_solution(sol)
    frozen = list(domain.vehicles[0].customers)
    assert frozen, "vehicle 0 serves no customer"
    for customer in frozen:
        customer.frozen = True
    # the stops of the initialized cotwin follow the vehicles' order:
    # vehicle 0's customers are the first stops
    want = [(0, c.vec_id) for c in frozen]
    sol2 = Solver.solve(db, cb, _agent(9, (0.2, 0.2, 0.2, 0.2, 0.1, 0.1)),
                        n_jobs=2, score_precision=[0, 0, 3],
                        logging_level=_SILENT, seed=2,
                        initial_solution=InitialSolution.from_domain(domain))
    values = [v for _, v in sol2[0]]
    got = [(values[2 * i], values[2 * i + 1]) for i in range(len(frozen))]
    assert got == want
    req = ScoreRequester(cb.build_cotwin(db.build_domain_from_scratch(),
                                         False))
    rescored = make_score_fn(req, [0, 0, 3])(
        torch.tensor([values], dtype=torch.float32))[0]
    assert rescored.tolist() == _score(sol2)
    replanned = db.build_from_solution(sol2, initial_domain=domain)
    assert [c.vec_id for c in replanned.vehicles[0].customers][:len(frozen)] \
        == [c.vec_id for c in frozen]
