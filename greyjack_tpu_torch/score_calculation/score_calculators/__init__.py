from greyjack_tpu_torch.score_calculation.score_calculators.score_calculator import (
    PlainScoreCalculator,
    IncrementalScoreCalculator,
)

__all__ = ["PlainScoreCalculator", "IncrementalScoreCalculator"]
