from greyjack_tpu_torch.score_calculation import scores
from greyjack_tpu_torch.score_calculation.score_calculators import (
    PlainScoreCalculator,
    IncrementalScoreCalculator,
)
from greyjack_tpu_torch.score_calculation.score_requesters import (
    VariablesManager,
    ScoreRequester,
)

__all__ = [
    "scores",
    "PlainScoreCalculator",
    "IncrementalScoreCalculator",
    "VariablesManager",
    "ScoreRequester",
]
