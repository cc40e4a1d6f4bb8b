"""The TSP sweep: the port's lower bound, a copy of the arithmetic of
`SweepConfig.conservative_moves_per_step` in `models/tsp/sweep.py`: the
change family whole but its no-op, the swap family less the partners that
a full tabu list could mask."""

import math


def per_island_step(config, args):
    n = config["n_locations"] - 1
    targets = min(int(args["sweep_targets"]), n)
    tabu_cap = int(math.ceil(float(args["tabu_entity_rate"]) * n))
    return targets * ((n - 1) + max(0, n - 1 - tabu_cap))
