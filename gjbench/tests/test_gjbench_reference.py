"""The plain reference agrees with the port on the CPU: the instance draws,
the greedy starts, the score of random solutions, and whole small solves
of every tiny cell, judged as a run on the card judges them."""

import time

import numpy as np
import pytest
import torch

from gjbench import harness
from gjbench.families import tsp as fam_tsp
from gjbench.families import vrp as fam_vrp
from gjbench.tests import _tiny

VRP_CFG = {"name": "vrp-tiny", **_tiny.CONFIGS["vrp-tiny"]}
TSP_CFG = {"name": "tsp-tiny", **_tiny.CONFIGS["tsp-tiny"]}
WL = {"cotwin": {"incremental": True, "greedy": True}}


def requester(mod, inst, incremental=True):
    from greyjack_tpu_torch.score_calculation.score_requesters import (
        ScoreRequester)
    db, cb = mod.builders(inst, {"cotwin": {"incremental": incremental,
                                            "greedy": True}}, "cpu")
    return ScoreRequester(cb.build_cotwin(db.build_domain_from_scratch(),
                                          False))


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 5])
def test_instances_are_the_ports_draws(seed):
    from greyjack_tpu_torch.models.tsp import generate_uniform_instance
    from greyjack_tpu_torch.models.vrp import generate_instance

    inst = fam_vrp.make_instance(VRP_CFG, np.random.default_rng(seed))
    plan = generate_instance(30, 2, 4, seed=seed, time_windowed=True,
                             device="cpu")
    assert [c.latitude for c in plan.customers_vec] == list(inst["xs"])
    assert [c.longitude for c in plan.customers_vec] == list(inst["ys"])
    assert [(c.demand, c.time_window_start, c.time_window_end,
             c.service_time) for c in plan.customers_vec] == list(zip(
        inst["demand"], inst["tw_start"], inst["tw_end"], inst["service"]))
    assert plan.vehicles[0].capacity == inst["capacity"]
    tsp = fam_tsp.make_instance(TSP_CFG, np.random.default_rng(seed))
    sched = generate_uniform_instance(30, seed=seed, device="cpu")
    assert [lc.latitude for lc in sched.locations_vec] == list(tsp["xs"])
    assert [lc.longitude for lc in sched.locations_vec] == list(tsp["ys"])


@pytest.mark.parametrize("mod,cfg", [(fam_vrp, VRP_CFG), (fam_tsp, TSP_CFG)],
                         ids=["vrp", "tsp"])
def test_greedy_start_is_the_ports(mod, cfg):
    inst = mod.make_instance(cfg, np.random.default_rng(11))
    req = requester(mod, inst)
    vm = req.variables_manager
    lay = mod.layout(vm.get_variables_names_vec())
    family = mod.Family(inst, "cpu", lay)
    assert np.array_equal(family.start(),
                          vm.initial_values.long().numpy())


@pytest.mark.parametrize("mod,cfg,precision", [
    (fam_vrp, VRP_CFG, None), (fam_tsp, TSP_CFG, None),
    (fam_tsp, TSP_CFG, [3, 3])], ids=["vrp", "tsp", "tsp-rounded"])
def test_rows_equal_the_ports_plain_score(mod, cfg, precision):
    """Random solutions (duplicates, overfull and empty routes, late
    stops): the reference's rows equal the port's full rescore."""
    from greyjack_tpu_torch.agents.base import make_score_fn

    inst = mod.make_instance(cfg, np.random.default_rng(5))
    req = requester(mod, inst, incremental=False)
    vm = req.variables_manager
    gen = torch.Generator().manual_seed(3)
    pop = vm.fix_all(vm.random_column_values(gen, (64,)))
    want = make_score_fn(req, precision)(pop)
    family = mod.Family(inst, "cpu",
                        mod.layout(vm.get_variables_names_vec()))
    got = family.rows(family.rep(pop), precision)
    assert torch.equal(got, want)


@pytest.mark.parametrize("cell", sorted(_tiny.CELLS))
def test_small_solves_are_correct(tiny_root, cell):
    result, info = harness.run(tiny_root, cell, 2 ** 31 + 17, 1.0, False,
                               "cpu", time.perf_counter())
    assert info["path"] == _tiny.CELLS[cell][1]["path"]
    assert {k: v["value"] for k, v in result["checks"].items()} == {
        k: 0 for k in result["checks"]}
    assert result["correct"] and result["failed"] == 0
    assert set(result["metrics"]) >= {"moves_per_s", "chunk_ms_p90",
                                      "setup_s"}
