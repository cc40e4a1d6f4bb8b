"""runner_step_host_ms (agent step: one pass of `IslandRunner._steps`'
loop: the extras, the active mask, the prestep, the kernel's step and
`mask_state`): host milliseconds a step inside the port's own
"gj.runner.step" span. It holds the range "gj.step" that `step_host_ms`
puts around the kernel's step from outside, so it reads a little above
that metric."""

from gjbench.metrics import _spans


def read(trace):
    return _spans.host_ms_per(trace, [_spans.STEP], _spans.STEP)
