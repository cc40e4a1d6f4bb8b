"""plain_rescore_device_ms (plain score: `ScoreRequester.
request_score_plain`): device milliseconds a step of the ops launched
inside the port's "gj.score.plain" span, the boundary
`plain_score_device_ms` times from outside."""

from gjbench.metrics import _spans


def read(trace):
    return _spans.device_ms_per_step(trace, "gj.score.plain")
