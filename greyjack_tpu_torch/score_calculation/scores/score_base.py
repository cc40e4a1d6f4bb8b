"""Host-side score objects.

On device a score is just a float64 row `score[..., S]` compared
lexicographically (see `greyjack_tpu_torch.ops.lexico`). These host classes carry
the same semantics as the reference `ScoreTrait` implementations
(`greyjack/src/score_calculation/scores/score_trait.rs:1-20`): total order,
addition, scalar multiply, fitness, priority score, truncating decimal round
and the f64::MAX-1 "stub" sentinel.
"""

from __future__ import annotations

import sys
from functools import total_ordering

from greyjack_tpu_torch.utils.math_utils import round_decimal

_STUB_VALUE = sys.float_info.max - 1.0


@total_ordering
class ScoreBase:
    """Lexicographically ordered multi-level score.

    Subclasses define COMPONENT_NAMES; values are stored as a plain list of
    floats in `self.values` (hard first).
    """

    COMPONENT_NAMES: tuple = ()

    def __init__(self, *values: float):
        if len(values) != len(self.COMPONENT_NAMES):
            raise ValueError(
                f"{type(self).__name__} expects {len(self.COMPONENT_NAMES)} "
                f"components, got {len(values)}"
            )
        self.values = [float(v) for v in values]

    # --- reference ScoreTrait surface -------------------------------------
    def get_sum_abs(self) -> float:
        return sum(abs(v) for v in self.values)

    def get_priority_score(self) -> float:
        """First strictly-positive level, else the last level
        (`hard_soft_score.rs:30-36`)."""
        for v in self.values[:-1]:
            if v > 0.0:
                return v
        return self.values[-1]

    def get_fitness_value(self) -> float:
        fits = [1.0 - (1.0 / (v + 1.0)) for v in self.values]
        weights = self._fitness_weights()
        return sum(w * f for w, f in zip(weights, fits))

    def _fitness_weights(self):
        n = len(self.values)
        if n == 1:
            return [1.0]
        if n == 2:
            return [0.5, 0.5]
        # reference uses 0.34/0.33/0.33 (`hard_medium_soft_score.rs:46-52`)
        return [0.34] + [0.33] * (n - 1)

    @classmethod
    def get_null_score(cls):
        return cls(*([0.0] * len(cls.COMPONENT_NAMES)))

    @classmethod
    def get_stub_score(cls):
        return cls(*([_STUB_VALUE] * len(cls.COMPONENT_NAMES)))

    def as_vec(self) -> list:
        return list(self.values)

    def mul(self, scalar: float):
        return type(self)(*[scalar * v for v in self.values])

    @classmethod
    def precision_len(cls) -> int:
        return len(cls.COMPONENT_NAMES)

    def round(self, precision) -> None:
        """In-place truncating decimal round, one precision per component."""
        self.values = [
            round_decimal(v, int(p)) for v, p in zip(self.values, precision)
        ]

    # --- ordering / arithmetic --------------------------------------------
    def __eq__(self, other):
        return isinstance(other, ScoreBase) and self.values == other.values

    def __lt__(self, other):
        return tuple(self.values) < tuple(other.values)

    def __add__(self, other):
        return type(self)(*[a + b for a, b in zip(self.values, other.values)])

    def __iadd__(self, other):
        self.values = [a + b for a, b in zip(self.values, other.values)]
        return self

    def __hash__(self):
        return hash(tuple(self.values))

    def __str__(self):
        return " | ".join(repr(v) if v != int(v) else str(v) for v in self.values)

    def __repr__(self):
        args = ", ".join(str(v) for v in self.values)
        return f"{type(self).__name__}({args})"

    # --- (de)serialization -------------------------------------------------
    def to_json(self):
        return {name: v for name, v in zip(self.COMPONENT_NAMES, self.values)}

    @classmethod
    def from_json(cls, obj):
        if isinstance(obj, dict):
            return cls(*[obj[name] for name in cls.COMPONENT_NAMES])
        return cls(*obj)

    @classmethod
    def from_row(cls, row):
        """Build from a device score row (array of S floats)."""
        return cls(*[float(v) for v in row])
