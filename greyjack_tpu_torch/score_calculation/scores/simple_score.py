"""Single-level score. Reference: `greyjack/src/score_calculation/scores/simple_score.rs`."""

from greyjack_tpu_torch.score_calculation.scores.score_base import ScoreBase


class SimpleScore(ScoreBase):
    COMPONENT_NAMES = ("simple_value",)

    def __init__(self, simple_value: float):
        super().__init__(simple_value)

    @property
    def simple_value(self) -> float:
        return self.values[0]

    def __str__(self):
        return f"{self.simple_value}"
