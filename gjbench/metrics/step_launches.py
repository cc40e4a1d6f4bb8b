"""step_launches (agent step): device operations a step (kernels, copies
and sets) whose launch lies inside the port's "gj.runner.step" span: the
number of dispatches a step makes, which a fusion or a graph capture
cuts."""

from gjbench.metrics import _spans


def read(trace):
    steps = sorted(_spans.begun(trace, _spans.STEP), key=lambda r: r[1])
    if not steps or not trace["device_ops"]:
        return None
    return len(_spans.launched_in(trace, steps)) / len(steps)
