"""The scoring path each local-search agent's kernel takes, from the one
place it is chosen (`agents/base.py` `scoring_path`): TabuSearch,
LateAcceptance and SimulatedAnnealing on a sweep-eligible VRP instance
with the sweep asked for, on one the sweep turns down (a time window past
its i32 bound), without the sweep, and on a cotwin without delta kernels;
and TabuSearch on an instance whose sums need i64 (labelled "int-delta",
its step scoring f64 rows). Each case pins the kernel's `path`,
`self_gating`, whether it has a `prestep` and a `refresh`, its
`moves_per_step`, and whether the sweep's fallback RuntimeWarning
fires."""

import warnings

import pytest

from greyjack_tpu_torch.agents import (LateAcceptance, SimulatedAnnealing,
                                       TabuSearch)
from greyjack_tpu_torch.agents.termination_strategies import StepsLimit
from greyjack_tpu_torch.models.vrp import CotwinBuilder, generate_instance
from greyjack_tpu_torch.score_calculation.score_requesters import (
    ScoreRequester)

# change / swap only: the narrow sampler, whose free lists are a prestep
_PROBAS = [0.5, 0.5, 0.0, 0.0, 0.0, 0.0]
_NEIGHBOURS = 16
# the sweep's static lower bound of scored moves a step at 8 targets,
# window 4, tabu rate 0.2 on the 30-customer instance
_SWEEP_MOVES = 232

# case -> (instance, sweep asked for)
_SETUPS = {"sweep": ("tw", True), "fallback": ("late", True),
           "delta": ("tw", False), "plain": ("plain", False),
           "i64": ("i64", False)}
# (agent, case) -> (path, self_gating, prestep, refresh, moves_per_step,
# the fallback warns)
_ONE = {"sweep": ("sweep", True, True, True, _SWEEP_MOVES, False),
        "fallback": ("delta", False, False, True, 1, True),
        "delta": ("delta", False, False, True, 1, False),
        "plain": ("plain", False, False, False, 1, False)}
TABLE = {
    ("TS", "sweep"): ("sweep", True, True, True, _SWEEP_MOVES, False),
    ("TS", "fallback"): ("int-delta", True, True, True, _NEIGHBOURS, True),
    ("TS", "delta"): ("int-delta", True, True, True, _NEIGHBOURS, False),
    ("TS", "plain"): ("plain", False, False, False, _NEIGHBOURS, False),
    ("TS", "i64"): ("int-delta", True, True, True, _NEIGHBOURS, False),
    **{(agent, case): row for agent in ("LA", "SA")
       for case, row in _ONE.items()},
}


@pytest.fixture(scope="module")
def requesters():
    out = {}
    for instance in ("tw", "late", "plain", "i64"):
        domain = generate_instance(30, 2, 5, seed=3, time_windowed=True,
                                   span=20000.0 if instance == "i64"
                                   else 100.0, device="cpu")
        if instance == "late":
            # one time window past the sweep's i32 time bound
            domain.customers_vec[5].time_window_start = 1 << 22
        out[instance] = ScoreRequester(CotwinBuilder(
            instance != "plain", True).build_cotwin(domain, False))
    return out


def _agent(name, sweep):
    kw = {"sweep": sweep, "sweep_targets": 8, "sweep_window": 4}
    if name == "TS":
        return TabuSearch(_NEIGHBOURS, 0.2, True, None, _PROBAS, 5,
                          StepsLimit(9), **kw)
    if name == "LA":
        return LateAcceptance(3, 0.2, None, _PROBAS, 5, StepsLimit(9), **kw)
    return SimulatedAnnealing([1000.0, 1000.0, 1.0], 0.9, 0.2, None,
                              _PROBAS, 5, StepsLimit(9), **kw)


@pytest.mark.parametrize("agent,case", sorted(TABLE))
def test_agent_path_table(requesters, agent, case):
    instance, sweep = _SETUPS[case]
    req = requesters[instance]
    assert req.supports_sweep == (instance == "tw")
    assert req.supports_delta == (instance != "plain")
    if instance == "i64":
        # the model registers the integer rows, the fused kernel turns
        # the instance down
        assert req.registers_delta_ints
        assert not req.delta_ints_eligible(2)
    ag = _agent(agent, sweep)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        kernel = ag.build_kernel(req, None)
    warned = [w for w in caught if issubclass(w.category, RuntimeWarning)
              and "sweep=True requested" in str(w.message)]
    path, gating, prestep, refresh, mps, warns = TABLE[(agent, case)]
    assert kernel.builder is ag
    assert kernel.path == path
    assert kernel.self_gating is gating
    assert (kernel.prestep is not None) is prestep
    assert (kernel.refresh is not None) is refresh
    assert kernel.moves_per_step == mps
    assert bool(warned) is warns
    assert len(warned) <= 1
