from greyjack_tpu_torch.agents.tabu_search import TabuSearch
from greyjack_tpu_torch.agents.late_acceptance import LateAcceptance
from greyjack_tpu_torch.agents.simulated_annealing import SimulatedAnnealing
from greyjack_tpu_torch.agents.genetic_algorithm import GeneticAlgorithm
from greyjack_tpu_torch.agents import termination_strategies

__all__ = ["TabuSearch", "LateAcceptance", "SimulatedAnnealing",
           "GeneticAlgorithm", "termination_strategies"]
