"""The ported slice end to end on the CPU: `Solver.solve` on a small VRP
runs the int-delta TabuSearch path, its returned score equals a plain
rescore of its returned solution, and the port never imports jax."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from greyjack_tpu_torch.models.vrp import (CotwinBuilder, DomainBuilder,
                                           generate_instance)
from greyjack_tpu_torch.agents import TabuSearch
from greyjack_tpu_torch.agents.termination_strategies import StepsLimit
from greyjack_tpu_torch.models.vrp import delta_kernel
from greyjack_tpu_torch.score_calculation.score_requesters import ScoreRequester
from greyjack_tpu_torch.solver import Solver, SolverLoggingLevels, SolverMetrics

torch.set_num_threads(1)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("tw", [True, False])
def test_solve_small_vrp_matches_plain_rescore(tw):
    def gen():
        return generate_instance(40, 2, 6, seed=3, time_windowed=tw,
                                 device="cpu")

    agent = TabuSearch(64, 0.2, True, None, [0.5, 0.5, 0, 0, 0, 0], 10,
                       StepsLimit(30))
    metrics = SolverMetrics()
    launches = delta_kernel._call_kernel.launches
    sol = Solver.solve(DomainBuilder.from_generator(gen),
                       CotwinBuilder(True, True), agent, 2, seed=11,
                       logging_level=SolverLoggingLevels.Silent,
                       metrics=metrics)
    # CPU tensors run the kernel's plain version: no launch counted
    assert delta_kernel._call_kernel.launches == launches
    assert {r["kernel_path"] for r in metrics.records} == {"int-delta"}
    # StepsLimit(30) with 10-step chunks: 31 steps -> 4 chunks
    assert len(metrics.records) == 4
    values = np.array([[v for _, v in sol[0]]], dtype=np.float32)
    req = ScoreRequester(CotwinBuilder(True, False).build_cotwin(gen(), False))
    rescored = req.request_score_plain(torch.from_numpy(values))[0]
    want = [sol[1]["hard_score"], sol[1]["medium_score"], sol[1]["soft_score"]]
    assert rescored.tolist() == want
    # the greedy start is feasible; the search keeps it so
    assert want[0] == 0.0


def test_port_imports_no_jax():
    code = ("import sys\n"
            "import greyjack_tpu_torch\n"
            "import greyjack_tpu_torch.solver, greyjack_tpu_torch.agents\n"
            "import greyjack_tpu_torch.models.vrp\n"
            "import greyjack_tpu_torch.models.vrp.delta_kernel\n"
            "import greyjack_tpu_torch.models.vrp.sweep\n"
            "import greyjack_tpu_torch.interop, greyjack_tpu_torch.cuda_build\n"
            "import greyjack_tpu_torch.agents.genetic_algorithm\n"
            "import greyjack_tpu_torch.agents.lshade\n"
            "import greyjack_tpu_torch.agents.base_individual\n"
            "import greyjack_tpu_torch.models.mixedint\n"
            "import greyjack_tpu_torch.domain\n"
            "import greyjack_tpu_torch.solver.checkpoint\n"
            "import greyjack_tpu_torch.solver.metrics\n"
            "import greyjack_tpu_torch.ops.moves, greyjack_tpu_torch.ops.selection\n"
            "import greyjack_tpu_torch.ops.lexico, greyjack_tpu_torch.parallel\n"
            "assert 'jax' not in sys.modules, 'jax imported'\n"
            "assert 'greyjack_tpu' not in sys.modules\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=_REPO)
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=_REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_unported_options_raise():
    """Of `Solver.solve`'s options only `mesh=` (multi-GPU islands, ROADMAP
    Queue 1) is still unported; it raises before any work is done."""
    agent = TabuSearch(8, 0.2, True, None, [0.5, 0.5, 0, 0, 0, 0], 2,
                       StepsLimit(2))

    class _Never:
        def build_domain_from_scratch(self):
            raise AssertionError("built a domain before refusing mesh=")

    with pytest.raises(NotImplementedError, match="mesh"):
        Solver.solve(_Never(), CotwinBuilder(True, True), agent, 1, seed=0,
                     mesh=object(),
                     logging_level=SolverLoggingLevels.Silent)
