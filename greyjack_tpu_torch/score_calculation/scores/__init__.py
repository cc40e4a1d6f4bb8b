from greyjack_tpu_torch.score_calculation.scores.score_base import ScoreBase
from greyjack_tpu_torch.score_calculation.scores.simple_score import SimpleScore
from greyjack_tpu_torch.score_calculation.scores.hard_soft_score import HardSoftScore
from greyjack_tpu_torch.score_calculation.scores.hard_medium_soft_score import (
    HardMediumSoftScore,
)

SCORE_CLASS_BY_SIZE = {1: SimpleScore, 2: HardSoftScore, 3: HardMediumSoftScore}

__all__ = [
    "ScoreBase",
    "SimpleScore",
    "HardSoftScore",
    "HardMediumSoftScore",
    "SCORE_CLASS_BY_SIZE",
]
