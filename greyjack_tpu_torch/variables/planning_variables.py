"""Planning-variable descriptors.

Host-side declarations only: the solver never touches these objects in the
hot path. At cotwin-compile time they are flattened into dense device arrays
(bounds / discrete-mask / frozen-mask / initial-values / semantic-group
tables) by `greyjack_tpu_torch.score_calculation.score_requesters.VariablesManager`.

Reference: `greyjack/src/variables/gj_float.rs`, `gj_integer.rs`.
"""

from __future__ import annotations

import random

from greyjack_tpu_torch.utils.math_utils import rint


class _PlanningVariable:
    is_discrete = False

    def __init__(self, initial_value, lower_bound, upper_bound, frozen=False,
                 semantic_groups=None):
        self.name = ""
        self.initial_value = None if initial_value is None else float(initial_value)
        self.lower_bound = float(lower_bound)
        self.upper_bound = float(upper_bound)
        self.frozen = bool(frozen)
        # default group "common" (`gj_integer.rs:36-43`)
        if semantic_groups is None:
            self.semantic_groups = ["common"]
        else:
            self.semantic_groups = list(semantic_groups)
        if self.frozen and self.initial_value is None:
            raise ValueError("Frozen variable must be initialized")

    def set_name(self, new_name: str) -> None:
        self.name = new_name

    def fix(self, value: float) -> float:
        """Clamp into bounds; frozen variables pin to the initial value
        (`gj_integer.rs:70-83`)."""
        if self.frozen:
            return self.initial_value
        fixed = min(max(value, self.lower_bound), self.upper_bound)
        if self.is_discrete:
            fixed = rint(fixed)
        return fixed

    def sample(self) -> float:
        if self.frozen:
            return self.initial_value
        return self._sample_impl()

    def get_initial_value(self) -> float:
        if self.initial_value is None:
            return self.sample()
        return self.initial_value


class GJFloat(_PlanningVariable):
    """Continuous planning variable, uniform over [lower, upper]."""

    is_discrete = False

    def _sample_impl(self) -> float:
        return random.uniform(self.lower_bound, self.upper_bound)

    def inverse_transform(self, value: float) -> float:
        return self.fix(value)


class GJInteger(_PlanningVariable):
    """Integer planning variable, uniform over {lower..upper} inclusive."""

    is_discrete = True

    def __init__(self, initial_value, lower_bound, upper_bound, frozen=False,
                 semantic_groups=None):
        if initial_value is not None:
            initial_value = float(int(initial_value))
        super().__init__(initial_value, int(lower_bound), int(upper_bound),
                         frozen, semantic_groups)

    def _sample_impl(self) -> float:
        return float(random.randint(int(self.lower_bound), int(self.upper_bound)))

    def inverse_transform(self, value: float) -> int:
        return int(self.fix(value))
