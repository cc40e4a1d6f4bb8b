"""The reader `plain_kernel_share` on canned traces: 100 where every plain
score opens the route analysis kernel's span, the share of plain scores
where some do not, ranges outside the window not counted, and nothing
where the program opens no kernel span (as a program without the kernel)
or scores nothing plainly; and its entry, appended to `per_layer`, names
the plain cell and the plain score's layer."""

import json

import pytest

from gjbench import harness, tracing
from gjbench.tests import _tiny


def chrome(kernel_scores, n_steps=4):
    """The window 0-1000 us: `n_steps` steps of 200 us from 50 us, a plain
    score in each and, in the steps `kernel_scores`, the kernel span inside
    it; one more step, with a plain score and a kernel range, begun before
    the window and ending inside it."""
    ev = []

    def user(name, ts, dur):
        ev.append({"ph": "X", "cat": "user_annotation", "name": name,
                   "ts": ts, "dur": dur, "args": {}})

    user("gj.window", 0, 1000)
    for i in range(-1, n_steps):
        t = 50 + 200 * i
        user("gj.runner.step", t, 180)
        user("gj.moves.sample", t + 5, 40)
        user("gj.score.plain", t + 50, 100 if i >= 0 else 170)
        if i < 0:
            user("gj.score.kernel", t + 60, 150)
        elif i in kernel_scores:
            user("gj.score.kernel", t + 60, 20)
    return {"traceEvents": ev}


def read(ch):
    return harness.reader("plain_kernel_share").read(
        tracing.reduce_trace(ch, 4, {}))


@pytest.mark.parametrize("kernel_scores,want", [
    ((0, 1, 2, 3), 100.0), ((0, 2), 50.0), ((3,), 25.0), ((), 0.0)])
def test_share_of_the_plain_scores_that_launch_the_kernel(kernel_scores,
                                                          want):
    assert read(chrome(kernel_scores)) == pytest.approx(want)


def test_nothing_without_the_kernel_span_or_plain_scores():
    no_kernel = chrome((0, 1))
    no_kernel["traceEvents"] = [e for e in no_kernel["traceEvents"]
                                if e["name"] != "gj.score.kernel"]
    assert read(no_kernel) is None
    no_plain = chrome((0, 1))
    no_plain["traceEvents"] = [e for e in no_plain["traceEvents"]
                               if e["name"] != "gj.score.plain"]
    assert read(no_plain) is None


def test_the_entry_is_appended_for_the_plain_cell():
    with open(f"{_tiny.ROOT}/BENCHMARK.json") as f:
        bench = json.load(f)
    entry = bench["per_layer"][-1]
    assert entry == {
        "name": "plain_kernel_share", "unit": "%", "better": "higher",
        "source": "program_span", "layer": "plain score",
        "moves": "moves_per_s", "workloads": ["vrp-tw-n1000.ts-plain"]}
    layers = {m["layer"] for m in bench["per_layer"]
              if m["name"] == "plain_rescore_device_ms"}
    assert layers == {entry["layer"]}
