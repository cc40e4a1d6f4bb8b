"""Host-side Individual (counterpart of
`greyjack_tpu/agents/base_individual.py`; reference
`individual.rs:7-59`): chromosome values and a score, totally ordered by
the score alone. The device path never builds these; they serve host-side
inspection, observers and tests.
"""

from __future__ import annotations

from functools import total_ordering

import numpy as np
import torch


def _host(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


@total_ordering
class Individual:
    def __init__(self, variable_values, score):
        self.variable_values = np.asarray(variable_values, dtype=np.float64)
        self.score = score

    def __eq__(self, other):
        return isinstance(other, Individual) and self.score == other.score

    def __lt__(self, other):
        return self.score < other.score

    def __repr__(self):
        return f"Individual(score={self.score})"

    @classmethod
    def from_state(cls, state, score_class, island=None):
        """The best individual of a runner state (tensors on any device):
        the global best, or island `island`'s best."""
        if island is None:
            values = _host(state["global_values"])
            row = _host(state["global_score"])
        else:
            values = _host(state["islands"]["top_values"][island])
            row = _host(state["islands"]["top_score"][island])
        return cls(values, score_class.from_row(row))
