"""Arithmetic shared by the readers of the port's own spans (the `gj.*`
ranges that `greyjack_tpu_torch/utils/tracing.py` opens inside the
program while a profiler records). Names are matched whole, so a range
the benchmark puts around a call from outside ("gj.step", "gj.sweep",
"gj.update_ctx", "gj.plain_score", "gj.chunk") never counts as one of
them.

A step is a "gj.runner.step" range, a chunk a "gj.runner.migrate" range,
each counted where it begins inside the window."""

import bisect

from gjbench import tracing

STEP = "gj.runner.step"
CHUNK = "gj.runner.migrate"


def begun(trace, name):
    """The ranges `name` that begin inside the window."""
    lo, hi = trace["window"]
    return [r for r in tracing.ranges_named(trace, name) if lo <= r[1] <= hi]


def host_ms_per(trace, names, per, less=()):
    """Host ms in the ranges `names` (less those in `less`), clipped to the
    window, over the ranges `per` that begin inside it; None where a range
    of `names` or of `per` is missing."""
    if not all(tracing.ranges_named(trace, n) for n in names):
        return None
    count = len(begun(trace, per))
    if not count:
        return None
    us = (sum(tracing.host_us_in(trace, n) for n in names)
          - sum(tracing.host_us_in(trace, n) for n in less))
    return us / count / 1e3


def device_ms_per_step(trace, name):
    """Device ms of the ops launched inside a range `name`, over the steps;
    None where the trace has no device op, no range `name` or no step."""
    steps = len(begun(trace, STEP))
    if (not steps or not trace["device_ops"]
            or not tracing.ranges_named(trace, name)):
        return None
    return tracing.device_us_under(trace, name) / steps / 1e3


def launched_in(trace, spans):
    """The device ops whose launch lies inside one of `spans` (sorted,
    disjoint [name, start, end] ranges)."""
    starts = [s for _, s, _ in spans]
    ops = []
    for op in trace["device_ops"]:
        at = op[3]
        if at is None:
            continue
        i = bisect.bisect_right(starts, at) - 1
        if i >= 0 and at <= spans[i][2]:
            ops.append(op)
    return ops
