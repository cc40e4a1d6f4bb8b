"""sweep_device_ms (sweep: `models/vrp/sweep.py`, `models/tsp/sweep.py`):
device milliseconds a step of the ops launched inside the sweep's
proposal (target draw, tables, candidate families, selection, exact
re-score)."""

from gjbench import tracing

SPANS = [("greyjack_tpu_torch.models.vrp.sweep:propose", "gj.sweep"),
         ("greyjack_tpu_torch.models.tsp.sweep:propose", "gj.sweep")]


def read(trace):
    if (not trace["steps"] or not trace["device_ops"]
            or not tracing.ranges_named(trace, "gj.sweep")):
        return None
    return tracing.device_us_under(trace, "gj.sweep") / trace["steps"] / 1e3
