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

Profiling: `Solver.solve(..., profile_dir=DIR)` captures a `torch.profiler`
trace (host, and the card when the solve runs on one) of chunks
[PROFILE_START_CHUNK, PROFILE_START_CHUNK + PROFILE_N_CHUNKS) and writes it
to DIR as a Chrome trace, `trace_chunks_<first>-<last>.json`. The trace
carries the `gj.*` spans of `utils/tracing.py` (the solver loop, the
island runner, the sampler, the agent step, the sweep, the delta scorer,
the ctx update, the plain score), on the clock of the card's activity.
"""

from __future__ import annotations

import os
import time

import torch

# the profiled window: chunks 2-4, past the first chunks' warm-up
PROFILE_START_CHUNK = 2
PROFILE_N_CHUNKS = 3


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


class ProfileCapture:
    """A `torch.profiler` trace bounded to the window of chunks above; it
    records the card's activity too when `device`, the solve's, is one,
    and the `gj.*` spans of `utils/tracing.py`, which open only while a
    profiler records."""

    def __init__(self, profile_dir, device):
        self.profile_dir = profile_dir
        self.device = torch.device(device)
        self._prof = None
        self._first = None
        self._done = False

    def tick(self, chunk_id):
        """Call once per chunk with the about-to-run chunk id."""
        if self.profile_dir is None or self._done:
            return
        if self._prof is None and chunk_id >= PROFILE_START_CHUNK:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=activities)
            self._prof.start()
            self._first = chunk_id
        elif (self._prof is not None
              and chunk_id >= PROFILE_START_CHUNK + PROFILE_N_CHUNKS):
            self._stop(chunk_id - 1)

    def close(self, last_chunk=None):
        if self._prof is not None:
            self._stop(last_chunk)

    def _stop(self, last_chunk):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._prof.stop()
        os.makedirs(self.profile_dir, exist_ok=True)
        last = self._first if last_chunk is None else last_chunk
        self._prof.export_chrome_trace(os.path.join(
            self.profile_dir, f"trace_chunks_{self._first}-{last}.json"))
        self._prof = None
        self._done = True
