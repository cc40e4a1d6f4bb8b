"""The VRP plan report of the port against the JAX package's
(`greyjack_tpu/models/vrp/domain.py:65-99`): from the same solution JSON
both packages build the same plan, and `get_trip_distance`,
`get_sum_travel_distance`, `get_trip_demand` return the same numbers and
`print_metrics` / `print_trip_paths` print the same text, character for
character. Tolerance: none."""

import numpy as np
import pytest
import torch

from greyjack_tpu.models.vrp import DomainBuilder as JDomainBuilder
from greyjack_tpu.models.vrp import generate_instance as j_generate
from greyjack_tpu_torch.models.vrp import DomainBuilder, generate_instance

torch.set_num_threads(1)


def _solution(n_customers, n_depots, k, seed):
    """A solution JSON: every customer on a random vehicle, some visited
    twice and one vehicle left empty."""
    rng = np.random.default_rng(seed)
    stops = list(range(n_depots, n_depots + n_customers))
    stops += list(rng.choice(stops, size=3))
    pairs = []
    for c in stops:
        pairs += [["vehicle_id", int(rng.integers(1, k))],
                  ["customer_id", int(c)]]
    return [pairs, {"hard_score": 0.0}]


@pytest.mark.parametrize("tw", [True, False])
def test_plan_report_matches_jax(capsys, tw):
    args = (30, 2, 5)
    sol = _solution(*args, seed=4)
    jdb = JDomainBuilder.from_generator(
        lambda: j_generate(*args, seed=9, time_windowed=tw))
    tdb = DomainBuilder.from_generator(
        lambda: generate_instance(*args, seed=9, time_windowed=tw,
                                  device="cpu"))
    jplan = jdb.build_from_solution(sol)
    tplan = tdb.build_from_solution(sol)
    assert tplan.vehicles[0].customers == []
    for jv, tv in zip(jplan.vehicles, tplan.vehicles, strict=True):
        assert tplan.get_trip_distance(tv) == jplan.get_trip_distance(jv)
        assert tplan.get_trip_demand(tv) == jplan.get_trip_demand(jv)
    assert tplan.get_sum_travel_distance() == jplan.get_sum_travel_distance()
    assert tplan.get_unique_stops_count() == jplan.get_unique_stops_count()

    outputs = []
    for plan in (jplan, tplan):
        plan.print_metrics()
        plan.print_trip_paths()
        outputs.append(capsys.readouterr().out)
    assert outputs[1] == outputs[0]
    assert "vehicle 4 trip metrics:" in outputs[1]
    assert "Solution distance: " in outputs[1]
