"""runner_host_ms (island runner: `parallel/islands.py` after the steps):
host milliseconds a chunk inside the port's "gj.runner.migrate",
"gj.runner.reduce" and "gj.runner.refresh" spans: the ring migration, the
global best and the per-chunk ctx rebuild."""

from gjbench.metrics import _spans

NAMES = ["gj.runner.migrate", "gj.runner.reduce", "gj.runner.refresh"]


def read(trace):
    return _spans.host_ms_per(trace, NAMES, _spans.CHUNK)
