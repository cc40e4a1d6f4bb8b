"""update_ctx_host_ms (ctx update: the models' `update_ctx`, through
`ScoreRequester.update_ctx`): host milliseconds a step applying the
accepted move to the delta ctx."""

from gjbench import tracing

SPANS = [("greyjack_tpu_torch.score_calculation.score_requesters."
          "score_requester:ScoreRequester.update_ctx", "gj.update_ctx")]


def read(trace):
    if not trace["steps"] or not tracing.ranges_named(trace, "gj.update_ctx"):
        return None
    return tracing.host_us_in(trace, "gj.update_ctx") / trace["steps"] / 1e3
