"""plain_score_device_ms (plain score: `ScoreRequester.request_score_plain`
down to `ops/routes.py`): device milliseconds a step of the ops launched
inside the full rescore of the neighbourhood."""

from gjbench import tracing

SPANS = [("greyjack_tpu_torch.score_calculation.score_requesters."
          "score_requester:ScoreRequester.request_score_plain",
          "gj.plain_score")]


def read(trace):
    if (not trace["steps"] or not trace["device_ops"]
            or not tracing.ranges_named(trace, "gj.plain_score")):
        return None
    return (tracing.device_us_under(trace, "gj.plain_score")
            / trace["steps"] / 1e3)
