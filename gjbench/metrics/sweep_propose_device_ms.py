"""sweep_propose_device_ms (sweep: the body of `propose` in
`models/vrp/sweep.py` and `models/tsp/sweep.py`): device milliseconds a
step of the ops launched inside the port's "gj.sweep.propose" span, the
boundary `sweep_device_ms` times from outside."""

from gjbench.metrics import _spans


def read(trace):
    return _spans.device_ms_per_step(trace, "gj.sweep.propose")
