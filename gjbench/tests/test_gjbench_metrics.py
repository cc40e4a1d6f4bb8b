"""Each metric reader reads a canned run record or a canned trace; the
copied arithmetic agrees with its originals."""

import math

import numpy as np
import pytest
import torch

from gjbench import harness, tracing
from gjbench.metrics import _kernel_bound, _moves


def chrome_trace():
    """A Chrome trace as torch.profiler exports it: the window 0-1000 us,
    two chunks, four steps, the sweep and update_ctx ranges, kernels with
    their launching runtime calls, one copy and one fused-kernel launch."""
    ev = []

    def x(cat, name, ts, dur, **args):
        ev.append({"ph": "X", "cat": cat, "name": name, "ts": ts,
                   "dur": dur, "args": args})

    x("user_annotation", "gj.window", 0, 1000)
    x("user_annotation", "gj.chunk", 0, 480)
    x("user_annotation", "gj.chunk", 500, 480)
    for i, s in enumerate((0, 240, 500, 740)):
        x("user_annotation", "gj.step", s, 200)
        x("user_annotation", "gj.sweep", s + 10, 100)
        x("user_annotation", "gj.update_ctx", s + 150, 40)
        x("cuda_runtime", "cudaLaunchKernel", s + 20, 5, correlation=10 * i)
        x("kernel", "void at::native::elementwise_kernel<128, 2, "
          "where_kernel_impl>(int)", s + 30, 50, correlation=10 * i)
        x("cuda_runtime", "cudaLaunchKernel", s + 160, 5,
          correlation=10 * i + 1)
        x("kernel", "void vrp_delta_shared<true, 2>(Args)", s + 170, 20,
          correlation=10 * i + 1)
    x("cuda_runtime", "cudaMemcpyAsync", 490, 5, correlation=99)
    x("gpu_memcpy", "Memcpy DtoH (Device -> Pinned)", 490, 5, correlation=99)
    # outside the window: read by no metric
    x("kernel", "void late_kernel<1>(int)", 2000, 50, correlation=500)
    return {"traceEvents": ev}


@pytest.fixture
def trace():
    return tracing.reduce_trace(chrome_trace(), 4,
                                {"vrp_delta.bound_us": [5.0] * 4})


def test_reduced_trace(trace):
    assert trace["window"] == [0.0, 1000.0]
    assert len(trace["device_ops"]) == 9
    assert {r[0] for r in trace["ranges"]} == {
        "gj.chunk", "gj.step", "gj.sweep", "gj.update_ctx"}
    assert trace["device_ops"][0][0] == "elementwise_kernel[where_kernel_impl]"


def test_per_layer_readers(trace):
    def read(name):
        return harness.reader(name).read(trace)

    # busy: 4 x 50 + 4 x 20 + 5 us of 1000
    assert read("device_idle_share") == pytest.approx(100 * (1 - 285 / 1000))
    assert read("step_host_ms") == pytest.approx(0.2)
    assert read("sweep_device_ms") == pytest.approx(0.05)
    assert read("update_ctx_host_ms") == pytest.approx(0.04)
    assert read("vrp_delta_roofline") == pytest.approx(25.0)
    # no plain-score range in this trace: the reader finds nothing
    assert read("plain_score_device_ms") is None


def test_readers_find_nothing_in_an_empty_window():
    empty = {"window": [0.0, 10.0], "steps": 0, "device_ops": [],
             "ranges": [], "counters": {}}
    for name in ("device_idle_share", "step_host_ms", "sweep_device_ms",
                 "update_ctx_host_ms", "vrp_delta_roofline",
                 "plain_score_device_ms"):
        assert harness.reader(name).read(empty) is None


def test_breakdown(trace):
    got = tracing.breakdown(trace)
    ops = dict(got["device_ops"])
    assert ops["elementwise_kernel[where_kernel_impl]"] == pytest.approx(2e-4)
    assert ops["vrp_delta_shared"] == pytest.approx(8e-5)
    idle = dict(got["idle_gaps"])
    assert sum(idle.values()) == pytest.approx((1000 - 285) / 1e6)
    assert "gj.step" in idle and set(idle) <= {
        "gj.chunk", "gj.step", "gj.sweep", "gj.update_ctx",
        tracing.HOST_SECTION}
    assert len(got["device_ops"]) <= 10 and len(got["idle_gaps"]) <= 10


def test_end_to_end_readers():
    config = {"family": "tsp", "n_locations": 1000, "span": 100.0}
    workload = {"chunk_steps": 10, "islands": 8, "moves": "neighbours",
                "agent_args": {"neighbours_count": 1024}}
    run = {"setup_s": 12.5, "cycles_s": [0.1] * 89 + [0.2] * 11,
           "window_s": 10.0, "window_chunks": 100,
           "final_score": [0.0, 2400.0], "config": config,
           "workload": workload}
    assert harness.reader("moves_per_s").read(run) == pytest.approx(
        100 * 10 * 8 * 1024 / 10.0)
    assert harness.reader("chunk_ms_p90").read(run) == pytest.approx(200.0)
    assert harness.reader("setup_s").read(run) == 12.5
    assert harness.reader("tour_len_norm").read(run) == pytest.approx(
        2400.0 / math.sqrt(1000 * 100.0 ** 2))
    assert harness.reader("tour_len_norm").read(
        dict(run, config={"family": "vrp"})) is None


@pytest.mark.parametrize("family", ["vrp", "tsp"])
def test_moves_per_step_is_the_ports_bound(family):
    """The copy equals `SweepConfig.conservative_moves_per_step` of the
    port on a small instance."""
    from gjbench.tests import _tiny
    from greyjack_tpu_torch.score_calculation.score_requesters import (
        ScoreRequester)

    cell = f"{family}-tiny.ts-sweep"
    config_name, wl = _tiny.CELLS[cell]
    config = {"name": config_name, **_tiny.CONFIGS[config_name]}
    workload = {**wl, "agent": "TabuSearch"}
    mod = __import__(f"gjbench.families.{family}", fromlist=["x"])
    inst = mod.make_instance(config, np.random.default_rng(3))
    db, cb = mod.builders(inst, workload, "cpu")
    req = ScoreRequester(cb.build_cotwin(db.build_domain_from_scratch(),
                                         False))
    cfg = req.sweep_module.SweepConfig(
        req, wl["agent_args"]["sweep_targets"],
        wl["agent_args"].get("sweep_window"))
    want = cfg.conservative_moves_per_step(
        req._delta_utils(), wl["agent_args"]["tabu_entity_rate"])
    assert _moves.per_island_step(config, workload) == want


def test_kernel_bound_on_known_inputs():
    """Two islands of two routes: route lengths 3 and 5 (Rp 128), kd 2;
    rows name routes 0 and 1 of each island."""
    rp, n_stops = 128, 100
    ctx = torch.full((2, 2, 6 * rp), n_stops, dtype=torch.int32)
    ctx[0, 0, :3] = 1
    ctx[0, 1, :5] = 1
    ctx[1, 0, :3] = 1
    ctx[1, 1, :5] = 1
    av = torch.tensor([[0], [1], [0], [1]], dtype=torch.int32)
    n_bytes, n_ops, seconds, by = _kernel_bound.bound(ctx, av, n_stops, True,
                                                      2, 2)
    need = [6, 8, 6, 8]
    sectors = sum((n * 4 + 31) // 32 for n in need)
    assert n_bytes == 6 * 32 * sectors + 4 * 4 + 2 * 4 * 4 * 8 * 4
    assert n_ops == 40 * sum(need)
    assert by == "bytes"
    assert seconds == pytest.approx(n_bytes / 3.35e12)


def test_short_names():
    assert tracing.short_name("Memcpy HtoD (Pageable -> Device)") == (
        "Memcpy HtoD (Pageable -> Device)")
    assert tracing.short_name(
        "void at::native::reduce_kernel<512, 1, at::native::ReduceOp<long, "
        "at::native::MinOps<long>>>(int)") == "reduce_kernel"
    assert tracing.short_name("void vrp_delta_direct<false, 1>(Args)") == (
        "vrp_delta_direct")
    # the fused kernel lives in an anonymous namespace
    assert tracing.short_name(
        "void (anonymous namespace)::vrp_delta_shared<true, 2>(Args)") == (
        "vrp_delta_shared")


def test_a_traced_run_ends_with_its_window(tiny_root):
    """The traced solve stops once the profiler window has closed, however
    long the run may be, and its per-layer metrics and check stand."""
    import time

    result, info = harness.run(tiny_root, "vrp-tiny.ts-plain", 2 ** 31 + 9,
                               600.0, True, "cpu", time.perf_counter())
    assert info["chunks"] == tracing.CHUNKS_NEEDED
    assert result["correct"], result["checks"]
    assert "step_host_ms" in result["metrics"]
    assert 0 < result["device"]["window_s"] < 600.0
