"""Observer pattern: every new global-best solution is pushed to registered
sinks. Reference: `greyjack/src/solver/observer_trait.rs:4-8`,
`agent_base.rs:571-581` (notified under the global-top mutex on each
improvement; here, at each host sync where the global best improved).
"""


class Observer:
    def update(self, solution) -> None:
        raise NotImplementedError

    def update_metrics(self, record) -> None:
        """Per-chunk metrics record (see `solver/metrics.py`); override to
        stream throughput/trajectory telemetry. Default: ignore."""
