"""sweep_families_device_ms (sweep: the four candidate families of
`models/tsp/sweep.py`): device milliseconds a step of the ops launched
inside the port's "gj.sweep.change", "gj.sweep.swap", "gj.sweep.two_opt"
and "gj.sweep.or_opt" spans: the [T, L] and [T, N] family arithmetic,
which grows with the tour where the rest of the step does not. None where
any of the four is missing."""

from gjbench.metrics import _spans

FAMILIES = ("gj.sweep.change", "gj.sweep.swap", "gj.sweep.two_opt",
            "gj.sweep.or_opt")


def read(trace):
    parts = [_spans.device_ms_per_step(trace, name) for name in FAMILIES]
    if any(p is None for p in parts):
        return None
    return sum(parts)
