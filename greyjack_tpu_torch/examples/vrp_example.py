"""VRP example (twin of `examples/vrp_example.py`; reference
`examples/vrp/src/main.rs`): single-stage, then multi-stage replanning with
vehicle 0's customers pinned.

    python -m greyjack_tpu_torch.examples.vrp_example [FILE.vrp]
        [--device cpu]
"""

import argparse

from greyjack_tpu_torch.agents import TabuSearch
from greyjack_tpu_torch.agents.termination_strategies import (
    ScoreNoImprovement)
from greyjack_tpu_torch.models.vrp import (CotwinBuilder, DomainBuilder,
                                           generate_instance)
from greyjack_tpu_torch.solver import Solver, SolverLoggingLevels
from greyjack_tpu_torch.solver.initial_solution import InitialSolution


def make_agent(limit_ms=60_000, neighbours=128):
    return TabuSearch(
        neighbours_count=neighbours,
        tabu_entity_rate=0.8,
        compare_to_global=True,
        mutation_rate_multiplier=None,
        move_probas=[0.5, 0.5, 0.0, 0.0, 0.0, 0.0],
        migration_frequency=10,
        termination_strategy=ScoreNoImprovement(limit_ms),
    )


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("vrp_file", nargs="?")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.vrp_file:
        domain_builder = DomainBuilder(args.vrp_file, device=args.device)
    else:
        domain_builder = DomainBuilder.from_generator(
            lambda: generate_instance(500, 5, 20, seed=42,
                                      time_windowed=True,
                                      device=args.device))
    cotwin_builder = CotwinBuilder(True, True)

    solution = Solver.solve(
        domain_builder, cotwin_builder, make_agent(),
        n_jobs=8, score_precision=[0, 0, 3],
        logging_level=SolverLoggingLevels.FreshOnly,
    )
    domain = domain_builder.build_from_solution(solution)
    domain.print_metrics()

    # --- multi-stage / replanning: pin vehicle 0's customers, re-solve
    for customer in domain.vehicles[0].customers:
        customer.frozen = True
    solution = Solver.solve(
        domain_builder, cotwin_builder, make_agent(limit_ms=10_000),
        n_jobs=8, score_precision=[0, 0, 3],
        logging_level=SolverLoggingLevels.FreshOnly,
        initial_solution=InitialSolution.from_domain(domain),
    )
    domain = domain_builder.build_from_solution(solution,
                                                initial_domain=domain)
    domain.print_metrics()
    domain.print_trip_paths()
    print("done")


if __name__ == "__main__":
    main()
