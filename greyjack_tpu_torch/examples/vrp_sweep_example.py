"""VRP with sweep neighbourhoods (twin of `examples/vrp_sweep_example.py`):
instead of `neighbours_count` random moves a step, every candidate value
of `sweep_targets` sampled stops is scored (change / vehicle
reassignment / cross-route swap families). Needs score_precision=None.

    python -m greyjack_tpu_torch.examples.vrp_sweep_example [FILE.vrp]
        [--device cpu]
"""

import argparse

from greyjack_tpu_torch.agents import TabuSearch
from greyjack_tpu_torch.agents.termination_strategies import TimeSpentLimit
from greyjack_tpu_torch.models.vrp import (CotwinBuilder, DomainBuilder,
                                           generate_instance)
from greyjack_tpu_torch.solver import Solver, SolverLoggingLevels


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
    agent = TabuSearch(
        neighbours_count=128,           # unused in sweep mode
        tabu_entity_rate=0.2,
        compare_to_global=True,
        mutation_rate_multiplier=None,
        move_probas=[0.5, 0.5, 0.0, 0.0, 0.0, 0.0],
        migration_frequency=10,
        termination_strategy=TimeSpentLimit(60_000),
        sweep=True,
        sweep_targets=64,
    )
    solution = Solver.solve(
        domain_builder, cotwin_builder, agent,
        n_jobs=8, score_precision=None,
        logging_level=SolverLoggingLevels.FreshOnly,
    )
    domain = domain_builder.build_from_solution(solution)
    domain.print_metrics()
    print("done")


if __name__ == "__main__":
    main()
