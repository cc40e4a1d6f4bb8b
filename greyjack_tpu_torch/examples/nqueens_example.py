"""N-Queens example (twin of `examples/nqueens_example.py`; reference
`examples/nqueens/src/main.rs`): TabuSearch with swap-only moves and
unique-row initialization, 256 queens to zero conflicts.

    python -m greyjack_tpu_torch.examples.nqueens_example [--device cpu]
"""

import argparse

from greyjack_tpu_torch.agents import TabuSearch
from greyjack_tpu_torch.agents.termination_strategies import ScoreLimit
from greyjack_tpu_torch.models.nqueens import CotwinBuilder, DomainBuilder
from greyjack_tpu_torch.score_calculation.scores import SimpleScore
from greyjack_tpu_torch.solver import Observer, Solver, SolverLoggingLevels


class NQueensObserver(Observer):
    """Called with every new global best solution JSON (reference
    `observers_examples/nqueens_observer.rs`)."""

    def __init__(self, domain_builder):
        self.domain_builder = domain_builder

    def update(self, solution):
        domain = self.domain_builder.build_from_solution(solution)
        print(f"[observer] conflicts now: {domain.conflict_count()}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    domain_builder = DomainBuilder(256, 45, device=args.device)
    cotwin_builder = CotwinBuilder(use_incremental_score_calculation=True)
    agent_builder = TabuSearch(
        neighbours_count=20,
        tabu_entity_rate=0.0,
        compare_to_global=True,
        mutation_rate_multiplier=None,
        move_probas=[0.0, 1.0, 0.0, 0.0, 0.0, 0.0],
        migration_frequency=10,
        termination_strategy=ScoreLimit(SimpleScore(0.0)),
    )
    solution = Solver.solve(
        domain_builder, cotwin_builder, agent_builder,
        n_jobs=8, score_precision=None,
        logging_level=SolverLoggingLevels.FreshOnly,
        observers=[NQueensObserver(domain_builder)],
    )
    domain = domain_builder.build_from_solution(solution)
    print(f"conflicts: {domain.conflict_count()}")
    print("done")


if __name__ == "__main__":
    main()
