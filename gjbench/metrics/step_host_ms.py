"""step_host_ms (agent step: `agents/*.py`, the kernel's step): host
milliseconds a step inside the "gj.step" range, which the tracer always
puts around the kernel's step."""

from gjbench import tracing


def read(trace):
    if not trace["steps"]:
        return None
    return tracing.host_us_in(trace, "gj.step") / trace["steps"] / 1000.0
