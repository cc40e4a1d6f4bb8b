"""delta_score_host_ms (delta scorer: `ScoreRequester.
request_score_delta_ints` / `request_score_delta`, down to the fused
kernel's `_pre`, launch and `_post`): host milliseconds a step inside the
port's "gj.delta.score" span."""

from gjbench.metrics import _spans


def read(trace):
    return _spans.host_ms_per(trace, ["gj.delta.score"], _spans.STEP)
