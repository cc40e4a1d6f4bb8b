"""winner_apply_device_ms (agent step: the step's winner written into the
population, the port's "gj.agent.apply" span in `agents/tabu_search.py`
and `agents/base.py`, and into the delta ctx, "gj.ctx.update" in
`ScoreRequester.update_ctx`): device milliseconds a step of the ops
launched inside either span, each op counted once. None where the program
has no "gj.agent.apply" span."""

from gjbench import tracing
from gjbench.metrics import _spans

NAMES = ("gj.agent.apply", "gj.ctx.update")


def read(trace):
    steps = len(_spans.begun(trace, _spans.STEP))
    if (not steps or not trace["device_ops"]
            or not all(tracing.ranges_named(trace, n) for n in NAMES)):
        return None
    spans = sorted((r for r in trace["ranges"] if r[0] in NAMES),
                   key=lambda r: r[1])
    us = 0.0
    for _, s, e, _ in _spans.launched_in(trace, spans):
        s, e = tracing.clip(s, e, trace["window"])
        us += max(0.0, e - s)
    return us / steps / 1e3
