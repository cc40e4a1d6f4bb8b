"""The traced run: labelled ranges around calls into the port's layers, a
profiler window of a few chunks, and the trace those leave, reduced to one
plain dict that the per-layer metric readers read.

The ranges are `torch.profiler.record_function` ranges put around the
port's functions from outside, as each metric file asks (`SPANS`): a
module function or class attribute ("module:attr", "module:Class.attr"), or
an attribute of the kernel the solve builds ("kernel:attr"). Two ranges are
always there: "gj.chunk" around `IslandRunner.run_chunk` and "gj.step"
around the kernel's step. The profiler starts before the timed solve, so
its own start-up stays outside; the window opens at the entry of chunk
`FIRST_CHUNK` of the timed solve and closes at the entry of the chunk
`TRACE_CHUNKS` later, each end after a device synchronisation.

The reduced trace:

  window      [start_us, end_us]
  steps       kernel steps that began inside the window
  device_ops  [[name, start_us, end_us, launch_us or None], ...]: kernels,
              copies and sets on the device, with the host time of the
              runtime call that launched each
  ranges      [[name, start_us, end_us], ...]: the labelled host ranges
  counters    {name: value}: what metric probes recorded
"""

from __future__ import annotations

import importlib
import json
import os
import re
import tempfile

import torch

FIRST_CHUNK = 2
TRACE_CHUNKS = 5
# chunks a traced solve runs: the window closes at the entry of the last
CHUNKS_NEEDED = FIRST_CHUNK + TRACE_CHUNKS + 1
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_SECTION = "solver.host_section"


def resolve(target):
    """(owner, attr) of "module:attr" or "module:Class.attr"."""
    mod, _, path = target.partition(":")
    owner = importlib.import_module(mod)
    *outer, attr = path.split(".")
    for name in outer:
        owner = getattr(owner, name)
    return owner, attr


def labelled(name, fn, counter=None):
    """fn inside a record_function range `name`."""
    def wrapped(*a, **k):
        if counter is not None:
            counter()
        with torch.profiler.record_function(name):
            return fn(*a, **k)
    return wrapped


class Tracer:
    """Installs the ranges and probes, runs the profiler window and reduces
    its trace. The harness calls `install()` before the timed solve,
    `on_chunk(idx, runner)` at the entry of every chunk and `close()` when
    the solve returns."""

    def __init__(self, modules, patch, device):
        self.modules = modules
        self.patch = patch
        self.device = torch.device(device)
        self.counters = {}
        self.finishers = []
        self.live = False
        self.steps = 0
        self.prof = None
        self.window = None
        self.path = None

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def install(self):
        seen = set()
        for mod in self.modules:
            for target, label in getattr(mod, "SPANS", ()):
                if target.startswith("kernel:") or target in seen:
                    continue
                seen.add(target)
                owner, attr = resolve(target)
                self.patch.set(owner, attr,
                               labelled(label, getattr(owner, attr)))
            if hasattr(mod, "probe"):
                mod.probe(self)
        # the profiler's own start-up (seconds on a first start) happens
        # here, before the timed solve; only the window is read
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=activities)
        self.prof.start()

    def _count_step(self):
        if self.live:
            self.steps += 1

    def on_chunk(self, idx, runner):
        if idx == FIRST_CHUNK - 1:
            kernel = runner.kernel
            self.patch.set(kernel, "step", labelled(
                "gj.step", kernel.step, self._count_step))
            for mod in self.modules:
                for target, label in getattr(mod, "SPANS", ()):
                    if target.startswith("kernel:"):
                        attr = target.split(":", 1)[1]
                        if getattr(kernel, attr, None) is not None:
                            self.patch.set(kernel, attr, labelled(
                                label, getattr(kernel, attr)))
        elif idx == FIRST_CHUNK:
            self._sync()
            self.window = torch.profiler.record_function("gj.window")
            self.window.__enter__()
            self.live = True
        elif idx == FIRST_CHUNK + TRACE_CHUNKS:
            self._stop()

    def _stop(self):
        if self.live:
            self._sync()
            self.window.__exit__(None, None, None)
            self.live = False
        if self.prof is not None:
            self.prof.stop()
            fd, self.path = tempfile.mkstemp(suffix=".json")
            os.close(fd)
            self.prof.export_chrome_trace(self.path)
            self.prof = None

    def close(self):
        """Stop the window if the solve ended inside it, and run the
        probes' finishers."""
        self._stop()
        for fn in self.finishers:
            fn()

    def read(self):
        """The reduced trace (None when no window was traced)."""
        if self.path is None:
            return None
        try:
            with open(self.path) as f:
                events = json.load(f)
        finally:
            os.remove(self.path)
            self.path = None
        return reduce_trace(events, self.steps, self.counters)


def reduce_trace(chrome, steps, counters):
    """The reduced trace (module docstring) of a Chrome trace dict."""
    events = chrome["traceEvents"] if isinstance(chrome, dict) else chrome
    launch = {}
    ranges = []
    window = None
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        if cat == "cuda_runtime" and "correlation" in e.get("args", {}):
            launch[e["args"]["correlation"]] = float(e["ts"])
        elif cat == "user_annotation" and e.get("name", "").startswith("gj."):
            span = [e["name"], float(e["ts"]), float(e["ts"]) + e["dur"]]
            if e["name"] == "gj.window":
                window = span[1:]
            else:
                ranges.append(span)
    if window is None:
        return None
    ops = []
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS:
            start, end = float(e["ts"]), float(e["ts"]) + e["dur"]
            if end < window[0] or start > window[1]:
                continue
            corr = e.get("args", {}).get("correlation")
            ops.append([short_name(e["name"]), start, end, launch.get(corr)])
    ranges = [r for r in ranges if r[2] >= window[0] and r[1] <= window[1]]
    return {"window": window, "steps": steps, "device_ops": ops,
            "ranges": ranges, "counters": counters}


GENERIC = {"gpu_kernel_impl", "gpu_kernel_impl_nocast", "elementwise_kernel",
           "vectorized_elementwise_kernel", "unrolled_elementwise_kernel"}


def short_name(name):
    """A device op's name without its template and argument lists: the
    kernel's own name, and in brackets the first operator named inside
    them (`elementwise_kernel[where_kernel_impl]`). Names without a
    template list (copies, sets) stay whole."""
    if "<" not in name:
        return name[:120]
    name = name.replace("(anonymous namespace)::", "")
    head = re.match(r"(?:void\s+)?([\w:]+)", name)
    if head is None:
        return name[:120]
    base = head.group(1).split("::")[-1]
    for inner in re.findall(r"(\w+(?:_kernel|_impl|Functor|_op)\w*)",
                            name[head.end():]):
        if inner != base and inner not in GENERIC:
            base = f"{base}[{inner}]"
            break
    return base[:120]


# --- arithmetic the readers share -------------------------------------------

def clip(start, end, window):
    return max(start, window[0]), min(end, window[1])


def busy_intervals(trace):
    """Merged [start, end] intervals in which a device op ran, clipped to
    the window."""
    spans = sorted(clip(s, e, trace["window"])
                   for _, s, e, _ in trace["device_ops"])
    merged = []
    for s, e in spans:
        if e <= s:
            continue
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def busy_us(trace):
    return sum(e - s for s, e in busy_intervals(trace))


def window_us(trace):
    return trace["window"][1] - trace["window"][0]


def ranges_named(trace, name):
    return [r for r in trace["ranges"] if r[0] == name]


def device_us_under(trace, name):
    """Device time of the ops whose launch lies inside a range `name`."""
    spans = sorted((s, e) for _, s, e in ranges_named(trace, name))
    total = 0.0
    for _, s, e, at in trace["device_ops"]:
        if at is not None and any(a <= at <= b for a, b in spans):
            s, e = clip(s, e, trace["window"])
            total += max(0.0, e - s)
    return total


def host_us_in(trace, name):
    """Summed host time of the ranges `name`, clipped to the window."""
    total = 0.0
    for _, s, e in ranges_named(trace, name):
        s, e = clip(s, e, trace["window"])
        total += max(0.0, e - s)
    return total


def breakdown(trace, top=10):
    """The device ops that took most time, and the idle time by the
    innermost labelled host range open in each gap (HOST_SECTION outside
    every range: the solver's loop between chunks), seconds each."""
    by_op = {}
    for name, s, e, _ in trace["device_ops"]:
        s, e = clip(s, e, trace["window"])
        by_op[name] = by_op.get(name, 0.0) + max(0.0, e - s) / 1e6
    idle = {}
    edge = trace["window"][0]
    gaps = []
    for s, e in busy_intervals(trace) + [[trace["window"][1]] * 2]:
        if s > edge:
            gaps.append((edge, s))
        edge = max(edge, e)
    for s, e in gaps:
        mid = (s + e) / 2
        inside = [r for r in trace["ranges"] if r[1] <= mid <= r[2]]
        name = (min(inside, key=lambda r: r[2] - r[1])[0] if inside
                else HOST_SECTION)
        idle[name] = idle.get(name, 0.0) + (e - s) / 1e6

    def top_of(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                ][:top]

    return {"device_ops": top_of(by_op), "idle_gaps": top_of(idle)}
