"""Per-chunk solve metrics.

Counterpart of `greyjack_tpu/solver/metrics.py` (`SolverMetrics`):

    metrics = SolverMetrics()
    Solver.solve(..., metrics=metrics)
    metrics.records      # one dict per chunk
    metrics.summary()    # aggregate throughput + best-score trajectory

Each record: {"chunk", "steps", "wall_ms", "moves", "moves_per_s",
"global_best", "improved", "n_alive", "migrations", "kernel_path"}, plus
"sweep_scored" / "sweep_nonconv" (cumulative over islands) on the sweep
path.
Observers implementing `update_metrics(record)` receive every record as it
lands. `wall_ms` is measured after the device finished the chunk.
"""

from __future__ import annotations

import time


class SolverMetrics:
    def __init__(self):
        self.records = []
        self.t_start = None

    def start(self):
        self.t_start = time.time()

    def add(self, record, observers=None):
        self.records.append(record)
        for obs in observers or ():
            fn = getattr(obs, "update_metrics", None)
            if fn is not None:
                fn(record)

    def summary(self):
        if not self.records:
            return {"chunks": 0, "moves": 0, "moves_per_s": 0.0,
                    "trajectory": []}
        moves = sum(r["moves"] for r in self.records)
        wall = sum(r["wall_ms"] for r in self.records) / 1e3
        return {
            "chunks": len(self.records),
            "moves": moves,
            "moves_per_s": moves / wall if wall > 0 else 0.0,
            "wall_s": wall,
            "trajectory": [
                (r["chunk"], r["global_best"]) for r in self.records
                if r["improved"]
            ],
        }
