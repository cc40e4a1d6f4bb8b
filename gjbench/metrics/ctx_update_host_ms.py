"""ctx_update_host_ms (ctx update: `ScoreRequester.update_ctx`): host
milliseconds a step inside the port's "gj.ctx.update" span, which sits at
the boundary `update_ctx_host_ms` times from outside."""

from gjbench.metrics import _spans


def read(trace):
    return _spans.host_ms_per(trace, ["gj.ctx.update"], _spans.STEP)
