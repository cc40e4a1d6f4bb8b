"""The reader `sample_kernel_share` on canned traces: 100 where every step
opens the plain sampler's kernel span, the share of steps where some do
not, ranges outside the window not counted, and nothing where the program
opens no kernel span (as a program without the kernel) or runs no step;
and its entry, appended at the end of `per_layer`, names the plain cell."""

import json

import pytest

from gjbench import harness, tracing
from gjbench.tests import _tiny


def chrome(kernel_steps, n_steps=4):
    """The window 0-1000 us: `n_steps` steps of 200 us from 50 us, the
    sampler span in each and, in the steps `kernel_steps`, the kernel span
    inside it; one more step, and a kernel range, begun before the window
    and ending inside it."""
    ev = []

    def user(name, ts, dur):
        ev.append({"ph": "X", "cat": "user_annotation", "name": name,
                   "ts": ts, "dur": dur, "args": {}})

    user("gj.window", 0, 1000)
    for i in range(-1, n_steps):
        t = 50 + 200 * i
        user("gj.runner.step", t, 180)
        user("gj.moves.sample", t + 5, 40)
        if i < 0:
            user("gj.moves.kernel", t + 20, 170)
        elif i in kernel_steps:
            user("gj.moves.kernel", t + 20, 10)
    return {"traceEvents": ev}


def read(ch):
    return harness.reader("sample_kernel_share").read(
        tracing.reduce_trace(ch, 4, {}))


@pytest.mark.parametrize("kernel_steps,want", [
    ((0, 1, 2, 3), 100.0), ((0, 2), 50.0), ((3,), 25.0)])
def test_share_of_the_steps_that_launch_the_kernel(kernel_steps, want):
    assert read(chrome(kernel_steps)) == pytest.approx(want)


def test_nothing_without_the_kernel_span_or_steps():
    assert read(chrome(())) == 0.0  # a range, but none begun in the window
    no_kernel = chrome(())
    no_kernel["traceEvents"] = [e for e in no_kernel["traceEvents"]
                                if e["name"] != "gj.moves.kernel"]
    assert read(no_kernel) is None
    no_steps = chrome((0, 1))
    no_steps["traceEvents"] = [e for e in no_steps["traceEvents"]
                               if e["name"] != "gj.runner.step"]
    assert read(no_steps) is None


def test_the_entry_is_appended_for_the_plain_cell():
    with open(f"{_tiny.ROOT}/BENCHMARK.json") as f:
        bench = json.load(f)
    entry = bench["per_layer"][-1]
    assert entry == {
        "name": "sample_kernel_share", "unit": "%", "better": "higher",
        "source": "program_span", "layer": "sampler",
        "moves": "moves_per_s", "workloads": ["vrp-tw-n1000.ts-plain"]}
    layers = {m["layer"] for m in bench["per_layer"]
              if m["name"] == "sample_host_ms"}
    assert layers == {entry["layer"]}
