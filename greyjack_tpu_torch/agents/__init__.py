from greyjack_tpu_torch.agents.tabu_search import TabuSearch
from greyjack_tpu_torch.agents import termination_strategies

__all__ = ["TabuSearch", "termination_strategies"]
