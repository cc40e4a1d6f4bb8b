"""TSP example (twin of `examples/tsp_example.py`; reference
`examples/tsp/src/main.rs`): a TSPLIB file, or without one a synthetic
1000-location instance, solved by TabuSearch with sweep neighbourhoods
under the reference's score_precision [3, 3] for 60 s.

    python -m greyjack_tpu_torch.examples.tsp_example [FILE.tsp]
        [--device cpu]
"""

import argparse

from greyjack_tpu_torch.agents import TabuSearch
from greyjack_tpu_torch.agents.termination_strategies import TimeSpentLimit
from greyjack_tpu_torch.models.tsp import (CotwinBuilder, DomainBuilder,
                                           generate_uniform_instance)
from greyjack_tpu_torch.solver import Solver, SolverLoggingLevels


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("tsp_file", nargs="?")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.tsp_file:
        domain_builder = DomainBuilder(args.tsp_file, device=args.device)
    else:
        domain_builder = DomainBuilder.from_generator(
            lambda: generate_uniform_instance(1000, seed=42,
                                              device=args.device))
    cotwin_builder = CotwinBuilder(use_incremental_score_calculation=True,
                                   use_greed_init=True)
    agent_builder = TabuSearch(
        neighbours_count=1024,
        tabu_entity_rate=0.5,
        compare_to_global=True,
        mutation_rate_multiplier=None,
        move_probas=[0.0, 0.2, 0.2, 0.2, 0.2, 0.2],
        migration_frequency=10,
        termination_strategy=TimeSpentLimit(60 * 1000),
        sweep=True,
        sweep_targets=64,
    )
    solution = Solver.solve(
        domain_builder, cotwin_builder, agent_builder,
        n_jobs=8, score_precision=[3, 3],
        logging_level=SolverLoggingLevels.FreshOnly,
    )
    domain = domain_builder.build_from_solution(solution)
    domain.print_metrics()
    print("done")


if __name__ == "__main__":
    main()
