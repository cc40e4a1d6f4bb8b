"""tour_len_norm: the tour length of the solution the solve returns, over
sqrt(n * A), n the cities (the depot included) and A the area of the square
they are drawn in: the DIMACS TSP Challenge's normalisation for random
uniform instances. Only for configurations of the TSP family."""

import math


def read(run):
    cfg = run["config"]
    if cfg["family"] != "tsp":
        return None
    return run["final_score"][1] / math.sqrt(cfg["n_locations"]
                                             * cfg["span"] ** 2)
