"""The port's entry points on the CPU: twin of `__graft_entry__.py`'s
checks (`tests/test_islands_multidevice.py::test_graft_dryrun`), the
example twins and the device defaults of this slice's entry points.

`entry()`'s step on its example population must give the JAX package's
plain score of the same rows, bit for bit; `dryrun_multichip` must pass
its three legs on a 2-rank gloo world it starts itself and in-process on
a 1-rank world made by `init_distributed`."""

import importlib
import inspect
import os
import subprocess
import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from greyjack_tpu.models.vrp import CotwinBuilder as JCotwinBuilder
from greyjack_tpu.models.vrp import generate_instance as j_generate
from greyjack_tpu.score_calculation.score_requesters import (
    ScoreRequester as JScoreRequester)
from greyjack_tpu_torch import entry as tentry
from greyjack_tpu_torch.models import tsp, vrp
from greyjack_tpu_torch.parallel.mesh import init_distributed
from greyjack_tpu_torch.service import HttpBroker, SolverService
from greyjack_tpu_torch.service.solver_service import JsonDomainBuilder

torch.set_num_threads(1)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = ["nqueens_example", "tsp_example", "vrp_example",
            "vrp_sweep_example", "vrp_service_example", "vrp_client"]


@pytest.mark.parametrize("fn", [
    vrp.DomainBuilder, vrp.domain.read_vrp_file, vrp.domain.scan_vrp_file,
    tsp.DomainBuilder, JsonDomainBuilder, SolverService, tentry.entry,
    tentry.dryrun_multichip, init_distributed])
def test_default_device_is_the_card(fn):
    assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_entry_step_matches_jax():
    step, (pop,) = tentry.entry(device="cpu")
    assert pop.shape[0] == 16 and pop.device.type == "cpu"
    jreq = JScoreRequester(JCotwinBuilder(True, False).build_cotwin(
        j_generate(32, 2, 6, seed=0, time_windowed=True), False))
    want = np.asarray(jreq.request_score_plain(jnp.asarray(pop.numpy())))
    got = step(pop)
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy(), want)


def test_dryrun_multichip_two_ranks():
    """`dryrun_multichip(2)` starts a 2-rank gloo world (spawned ranks):
    leg 3 runs an (1, 2) islands x facts grid."""
    tentry.dryrun_multichip(2, device="cpu")
    assert not dist.is_initialized()


def test_dryrun_multichip_in_an_initialised_world(tmp_path, capsys):
    mesh = init_distributed("file://" + str(tmp_path / "store"), 1, 0,
                            device="cpu")
    try:
        assert (mesh.size, mesh.index, mesh.device.type) == (1, 0, "cpu")
        assert dist.get_backend() == "gloo"
        tentry.dryrun_multichip(1, device="cpu")
        with pytest.raises(ValueError, match="not 2"):
            tentry.dryrun_multichip(2, device="cpu")
    finally:
        dist.destroy_process_group()
    out = capsys.readouterr().out
    assert "partitioned-facts ok" in out and "delta-kernel ok" in out


@pytest.mark.parametrize("name", EXAMPLES)
def test_examples_take_device(name, capsys):
    """Each example twin parses the JAX example's arguments and
    `--device`."""
    module = importlib.import_module(f"greyjack_tpu_torch.examples.{name}")
    with pytest.raises(SystemExit) as done:
        module.main(["--help"])
    assert done.value.code == 0
    assert "--device" in capsys.readouterr().out


def test_example_runs_as_a_module():
    out = subprocess.run(
        [sys.executable, "-m", "greyjack_tpu_torch.examples.nqueens_example",
         "--help"], cwd=_REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "--device" in out.stdout


def test_vrp_client_streams_until_finished():
    """The client twin against an HTTP broker: it submits the generated
    task and prints each streamed solution until "Solving finished"."""
    from greyjack_tpu_torch.examples import vrp_client

    broker = HttpBroker(port=0)
    result = {}

    def run():
        result["rc"] = vrp_client.main(
            ["--port", str(broker.port), "--customers", "10",
             "--depots", "1", "--vehicles", "3", "--device", "cpu"])

    try:
        thread = threading.Thread(target=run)
        thread.start()
        task = broker.next_task(timeout=30)
        assert task["customers_dict"]["n_customers"] == 11
        assert (task["user_id"], task["task_id"]) == (13, 45)
        broker.publish_solution({"sum_travel_distance": 1.5,
                                 "unique_stops": 10, "trips": [[], []]})
        broker.publish_solution("Solving finished")
        thread.join(timeout=60)
        assert not thread.is_alive()
    finally:
        broker.close()
    assert result["rc"] == 0
