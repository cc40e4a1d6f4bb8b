from greyjack_tpu_torch.service.solver_service import (SolverService,
                                                       SolutionObserver)
from greyjack_tpu_torch.service.brokers import InProcessBroker, HttpBroker

__all__ = ["SolverService", "SolutionObserver", "InProcessBroker",
           "HttpBroker"]
