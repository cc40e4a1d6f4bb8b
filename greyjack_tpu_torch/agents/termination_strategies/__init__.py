from greyjack_tpu_torch.agents.termination_strategies.strategies import (
    StepsLimit,
    TimeSpentLimit,
    ScoreNoImprovement,
    ScoreLimit,
)

# reference enum-variant aliases (`termination_strategies_variants.rs:11-18`)
StL = StepsLimit
TSL = TimeSpentLimit
SNI = ScoreNoImprovement
ScL = ScoreLimit

__all__ = [
    "StepsLimit",
    "TimeSpentLimit",
    "ScoreNoImprovement",
    "ScoreLimit",
    "StL",
    "TSL",
    "SNI",
    "ScL",
]
