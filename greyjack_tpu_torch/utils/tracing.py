"""Labelled host ranges ("spans") at the layer boundaries of a solve.

    with span("gj.sweep.propose"):
        ...

While a `torch.profiler` session records, `span(name)` is
`torch.profiler.record_function(name)`: the range lands in the profiler's
trace on Kineto's clock, beside the CUPTI activity of the card, so every
device op whose launch (its `cuda_runtime` call) falls inside the range was
issued by that stage. Otherwise it is one shared null context: the check
is the profiler's own flag, read at each entry, and costs well under a
microsecond, where entering `record_function` with no profiler costs about
ten. Nothing turns the spans on but a profiler: `Solver.solve(profile_dir=
...)` (`solver/metrics.ProfileCapture`), or any session a caller starts.

The spans, by layer, and the per-layer metric of the benchmark
(`gjbench/metrics/<metric>.py`) that reads each; a span with no metric is
read by the trace's idle breakdown alone.

  solver loop (`solver/solver.py`)
    gj.solver.host       an iteration's host work outside `run_chunk`
                         (two entries a chunk)       solver_host_ms
    gj.solver.sync       its device->host reads      solver_host_ms (less)
  island runner (`parallel/islands.py`)
    gj.runner.step       one step of every island    runner_step_host_ms,
                                                     step_launches
    gj.runner.prestep    the kernel's prestep (the tabu free lists)
    gj.runner.migrate    ring migration, once a chunk  runner_host_ms
    gj.runner.reduce     the global best               runner_host_ms
    gj.runner.refresh    the per-chunk ctx rebuild     runner_host_ms
  sampler (`ops/moves.py`, and the plain step's fix of the moved rows)
    gj.moves.sample                                  sample_host_ms
    gj.moves.kernel      the plain sampler's CUDA kernel launch
                         (`ops/move_kernel.py`)      sample_kernel_share
  agent step (`agents/base.py`, the local-search step `LocalSearch`)
    gj.agent.propose     the sweep step's proposal: tabu masks, the
                         model's `propose`, the active-winner mask
    gj.agent.accept      winner, acceptance, apply, tabu push, best, step
    gj.agent.apply       the winner written into the population (in
                         gj.agent.accept)       winner_apply_device_ms
  sweep (`models/vrp/sweep.py`, `models/tsp/sweep.py`)
    gj.sweep.propose     the whole proposal          sweep_propose_device_ms
    gj.sweep.targets     target draw and tabu rows
    gj.sweep.tables      VRP: the route tables and the targets' rows;
                         TSP: the targets' distance-matrix rows
    gj.sweep.change / .vehicle / .swap           (VRP candidate families)
    gj.sweep.change / .swap / .two_opt / .or_opt (TSP candidate families)
                                                 sweep_families_device_ms
    gj.sweep.select      winner, decode, tabu info, stats
    gj.sweep.exact       the winner's exact delta row
  delta scorer (`ScoreRequester.request_score_delta[_ints]`,
  `models/vrp/delta_kernel.py`)
    gj.delta.score                                   delta_score_host_ms
    gj.delta.pre / .kernel / .post    the fused kernel's three stages
  ctx update (`ScoreRequester`)
    gj.ctx.update        `update_ctx`                ctx_update_host_ms,
                                                     winner_apply_device_ms
    gj.ctx.build         `build_base_ctx`
  plain score (`ScoreRequester.request_score_plain`)
    gj.score.plain                                   plain_rescore_device_ms
"""

from __future__ import annotations

import contextlib

import torch.autograd.profiler as _profiler
from torch.profiler import record_function

_OFF = contextlib.nullcontext()


def span(name):
    """A `record_function(name)` range while a profiler records, else a
    shared null context."""
    if _profiler._is_profiler_enabled:
        return record_function(name)
    return _OFF
