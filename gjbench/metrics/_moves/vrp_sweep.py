"""The VRP sweep: the port's lower bound, a copy of the arithmetic of
`SweepConfig.conservative_moves_per_step` in `models/vrp/sweep.py`: the
change family whole but its no-op, the swap family less the partners that
frozen stops, a full tabu list and a full route could mask, the vehicle
family not at all."""

import math


def route_cap(n_stops, k):
    """The port's route buffer width (`_route_cap` of the VRP cotwin)."""
    return int(min(n_stops, max(48, -(-4 * n_stops // k))))


def per_island_step(config, args):
    n = config["n_customers"]
    targets = min(int(args["sweep_targets"]), n)
    tabu_cap = int(math.ceil(float(args["tabu_entity_rate"]) * max(1, n)))
    cap = route_cap(n, config["k_vehicles"])
    return targets * ((n - 1) + max(0, n - tabu_cap - cap - 1))
