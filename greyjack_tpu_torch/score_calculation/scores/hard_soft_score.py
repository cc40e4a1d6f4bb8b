"""Two-level lexicographic score. Reference: `greyjack/src/score_calculation/scores/hard_soft_score.rs`."""

from greyjack_tpu_torch.score_calculation.scores.score_base import ScoreBase


class HardSoftScore(ScoreBase):
    COMPONENT_NAMES = ("hard_score", "soft_score")

    def __init__(self, hard_score: float, soft_score: float):
        super().__init__(hard_score, soft_score)

    @property
    def hard_score(self) -> float:
        return self.values[0]

    @property
    def soft_score(self) -> float:
        return self.values[1]

    def __str__(self):
        return f"{self.hard_score} | {self.soft_score}"
