from greyjack_tpu_torch.solver.solver import Solver
from greyjack_tpu_torch.solver.solver_logging_levels import SolverLoggingLevels
from greyjack_tpu_torch.solver.observer import Observer
from greyjack_tpu_torch.solver.initial_solution import InitialSolution
from greyjack_tpu_torch.solver.metrics import SolverMetrics

__all__ = ["Solver", "SolverLoggingLevels", "Observer", "InitialSolution",
           "SolverMetrics"]
