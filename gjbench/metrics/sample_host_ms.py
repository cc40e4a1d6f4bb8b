"""sample_host_ms (sampler: `ops/moves.py` `move_population_delta`,
`move_population`, and the plain step's fix of the moved rows): host
milliseconds a step inside the port's "gj.moves.sample" spans."""

from gjbench.metrics import _spans


def read(trace):
    return _spans.host_ms_per(trace, ["gj.moves.sample"], _spans.STEP)
