"""solver_host_ms (solver loop: `Solver.solve` between chunks): host
milliseconds a chunk inside the port's "gj.solver.host" spans, less their
"gj.solver.sync" children (the device-to-host reads, which wait for the
chunk's device work): budgets, the copies of the chunk's arguments,
termination, the conversion of a new best, observers, log and
checkpoint."""

from gjbench.metrics import _spans


def read(trace):
    return _spans.host_ms_per(trace, ["gj.solver.host"], _spans.CHUNK,
                              less=["gj.solver.sync"])
