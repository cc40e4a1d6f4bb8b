"""Termination strategies (host-side, per island).

Reference: `greyjack/src/agents/termination_strategies/*.rs`. These are
cheap host objects updated once per solving *chunk* (the jitted inner loop
runs `migration_frequency` steps between host syncs); `StepsLimit` stays
exact because the runner sizes chunks to never overshoot the limit.
`get_accomplish_rate` feeds the SimulatedAnnealing auto-temperature
(`agent_base.rs:537-552`).
"""

from __future__ import annotations

import copy
import time


class TerminationStrategy:
    def is_accomplish(self) -> bool:
        raise NotImplementedError

    def get_accomplish_rate(self) -> float:
        raise NotImplementedError

    def predict_accomplish_rate(self, steps: int) -> float:
        """Accomplish rate expected `steps` device steps from now — the end
        point of the per-step lerp the island runner applies inside a chunk
        (SA auto-temperature, `agent_base.rs:537-552`). Default: constant
        (time-based strategies stay chunk-granular — wall time per device
        step is unknown to the host; documented divergence)."""
        return self.get_accomplish_rate()

    def clone(self):
        return copy.deepcopy(self)


class StepsLimit(TerminationStrategy):
    """`steps_limit.rs:4-37` — accomplish when steps_made > limit."""

    def __init__(self, steps_limit: int):
        self.steps_limit = int(steps_limit)
        self.steps_made = 0

    def update(self, agent_top_score=None, steps: int = 1):
        self.steps_made += steps

    def is_accomplish(self) -> bool:
        return self.steps_made > self.steps_limit

    def get_accomplish_rate(self) -> float:
        return self.steps_made / self.steps_limit

    def predict_accomplish_rate(self, steps: int) -> float:
        # linear in steps -> the in-chunk per-step lerp is exact
        return (self.steps_made + steps) / self.steps_limit


class TimeSpentLimit(TerminationStrategy):
    """`time_spent_limit.rs:5-50` — wall-clock ms since first update."""

    def __init__(self, limit_milliseconds: int):
        self.limit_milliseconds = int(limit_milliseconds)
        self.start_time = None
        self.time_delta = 0

    def update(self, agent_top_score=None, steps: int = 1):
        now = time.time() * 1000.0
        if self.start_time is None:
            self.start_time = now
            return
        self.time_delta = now - self.start_time

    def is_accomplish(self) -> bool:
        return self.time_delta >= self.limit_milliseconds

    def get_accomplish_rate(self) -> float:
        return self.time_delta / self.limit_milliseconds


class ScoreNoImprovement(TerminationStrategy):
    """`score_no_improvement.rs:9-63` — reset timer on improvement; freeze
    once accomplished (prevents migrant updates from reviving the agent)."""

    def __init__(self, limit_milliseconds: int):
        self.limit_milliseconds = int(limit_milliseconds)
        self.start_time = None
        self.current_best_score = None
        self.time_delta = 0

    def update(self, agent_top_score=None, steps: int = 1):
        now = time.time() * 1000.0
        if self.start_time is None:
            self.start_time = now
            self.current_best_score = agent_top_score
            return
        if self.is_accomplish():
            return
        if (
            agent_top_score is not None
            and (self.current_best_score is None
                 or agent_top_score < self.current_best_score)
        ):
            self.current_best_score = agent_top_score
            self.start_time = now
            self.time_delta = 0
        else:
            self.time_delta = now - self.start_time

    def is_accomplish(self) -> bool:
        return self.time_delta >= self.limit_milliseconds

    def get_accomplish_rate(self) -> float:
        return self.time_delta / self.limit_milliseconds


class ScoreLimit(TerminationStrategy):
    """`score_limit.rs:8-57` — accomplish when best score <= target."""

    def __init__(self, target_score):
        self.target_score = target_score
        self.current_best_score = None

    def update(self, agent_top_score=None, steps: int = 1):
        self.current_best_score = agent_top_score

    def is_accomplish(self) -> bool:
        if self.current_best_score is None:
            return False
        return self.current_best_score <= self.target_score

    def get_accomplish_rate(self) -> float:
        if self.current_best_score is None:
            return 0.0
        return self.current_best_score.get_fitness_value() / (
            self.target_score.get_fitness_value() + 1e-10
        )
