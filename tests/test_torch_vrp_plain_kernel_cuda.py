"""The VRP plain score's route analysis kernel (`csrc/vrp_plain.cu`)
against the torch body of `build_common`, on the card: its four integer
outputs (distance in milli, time penalty, N - distinct customers, loads)
equal the torch body's run on the card and on a CPU copy, and the plain
score rows of `request_score_plain` are bit-equal with the kernel, with
the torch body forced on the card, and on the CPU. Cases: the VRP n=1000
cell's shape at 384 rows; an empty vehicle; every stop on one vehicle
(its route late and over time, checked by a walk in Python); repeated
customer ids; only vehicles 0 and K - 1; no time windows; rows whose
working set does not fit a block's shared memory (N = 15,000 stops,
8,000 vehicles, and the cell's shape with the shared-memory limit
lowered, fewer blocks than rows), which loop over a global scratch; and a
time walk far past the i32 range, against a walk in Python. Then a 6-step
plain
TabuSearch chunk, bit-equal with the kernel and with the torch body; a
traced plain solve whose every plain score opens `gj.score.kernel` inside
`gj.score.plain`; and the wrapper's refusals.

Needs an NVIDIA GPU with the CUDA toolkit; skips elsewhere. This file
imports only the port, so it also runs where jax is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_vrp_plain_kernel_cuda.py
"""

import json

import pytest
import torch

from greyjack_tpu_torch.agents import TabuSearch
from greyjack_tpu_torch.agents.termination_strategies import StepsLimit
from greyjack_tpu_torch.models.vrp import (CotwinBuilder, DomainBuilder,
                                           generate_instance)
from greyjack_tpu_torch.ops import join, plain_kernel, routes, segments
from greyjack_tpu_torch.parallel.islands import IslandRunner
from greyjack_tpu_torch.score_calculation.score_requesters import (
    ScoreRequester)
from greyjack_tpu_torch.solver import Solver, SolverLoggingLevels
from greyjack_tpu_torch.solver.solver import island_generators

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _requester(device, n, depots, k, tw, seed=5):
    """The plain VRP requester, no greedy start: `sample_variables` then
    draws every stop's vehicle and customer at random."""
    domain = generate_instance(n, depots, k, seed=seed, time_windowed=tw,
                               device=device)
    return ScoreRequester(CotwinBuilder(False, False).build_cotwin(domain,
                                                                   False))


def _utils(req):
    return dict(req.cotwin.score_calculator.utility_objects)


def _population(req, p, seed=11):
    vm = req.variables_manager
    gen = island_generators(seed, 1, vm.device)[0]
    return vm.sample_variables(gen, p)


def _torch_ints(v, c, utils):
    """The torch body's integers: (milli distance i64, time penalty i64,
    N - distinct i64, loads i32)."""
    sorted_v, perm = routes.sort_stops_by_vehicle(v)
    sorted_c = join.apply_permutation(c, perm)
    cust_rows = utils["cust_packed"][sorted_c.long()]
    dist, late = routes.vrp_routes_packed(
        sorted_v, sorted_c, utils["dm_flat_milli"], utils["n_locations"],
        utils["vehicle_depot_ids"], utils["work_day_start_k"],
        utils["work_day_end_k"], cust_rows, utils["time_windowed"],
        precision=0)
    dups = segments.count_minus_n_unique(c, utils["n_locations"])
    loads = segments.segment_sum(cust_rows[..., 0], sorted_v,
                                 utils["k_vehicles"])
    return (dist.to(torch.int64), late.to(torch.int64),
            dups.to(torch.int64), loads)


def _cpu_utils(utils):
    return {k: x.cpu() if isinstance(x, torch.Tensor) else x
            for k, x in utils.items()}


def _compare(req, pop):
    """The kernel's outputs == the torch body's on the card and on the CPU;
    returns them and the score rows, scored with one kernel launch."""
    utils = _utils(req)
    cols = req.build_frames(pop)["planning_stops"]
    v, c = cols["vehicle_id"].contiguous(), cols["customer_id"].contiguous()
    assert plain_kernel.eligible(v, utils)
    got = plain_kernel.route_analysis(v, c, utils)
    want = _torch_ints(v, c, utils)
    want_cpu = _torch_ints(v.cpu(), c.cpu(), _cpu_utils(utils))
    names = ("distance", "penalty", "dups", "loads")
    for name, g, w, wc in zip(names, got, want, want_cpu):
        assert g.shape == w.shape, name
        assert torch.equal(g.long().cpu(), w.long().cpu()), name
        assert torch.equal(w.cpu(), wc), name
    assert got[3].dtype == torch.int32 and got[2].dtype == torch.int32

    before = plain_kernel.route_analysis.launches
    rows = req.request_score_plain(pop)
    assert plain_kernel.route_analysis.launches == before + 1
    return got, rows


def _scores_agree(req, shape, pop, rows, monkeypatch):
    """The rows with the kernel == with the torch body forced on the card
    == on the CPU (a requester built there from the same instance)."""
    with monkeypatch.context() as m:
        m.setattr(plain_kernel, "eligible", lambda v, utils: False)
        before = plain_kernel.route_analysis.launches
        forced = req.request_score_plain(pop)
        assert plain_kernel.route_analysis.launches == before
    assert torch.equal(rows, forced)
    cpu_req = _requester("cpu", *shape)
    assert torch.equal(rows.cpu(), cpu_req.request_score_plain(pop.cpu()))


def _set_columns(req, pop, v=None, c=None):
    """`pop` with the stops' vehicle / customer columns replaced (the
    variables alternate vehicle, customer per stop)."""
    pop = pop.clone()
    if v is not None:
        pop[:, 0::2] = v.to(pop.dtype)
    if c is not None:
        pop[:, 1::2] = c.to(pop.dtype)
    cols = req.build_frames(pop)["planning_stops"]
    if v is not None:
        assert torch.equal(cols["vehicle_id"], v.to(torch.int32))
    if c is not None:
        assert torch.equal(cols["customer_id"], c.to(torch.int32))
    return pop


def test_cell_shape(cuda, monkeypatch):
    shape = (1000, 8, 40, True)
    req = _requester(cuda, *shape)
    pop = _population(req, 384)
    got, rows = _compare(req, pop)
    assert (got[1] > 0).all() and (got[2] > 0).all()
    _scores_agree(req, shape, pop, rows, monkeypatch)


def _walk(utils, route):
    """Python walk of one route (customer ids in order) of vehicle 0:
    (lateness summed, overtime)."""
    packed = utils["cust_packed"].cpu().tolist()
    post = int(utils["work_day_start_k"][0])
    late = 0
    for cid in route:
        _, s, e, t = packed[cid]
        post = max(post, s) + t
        late += max(post - e, 0)
    return late, max(post - int(utils["work_day_end_k"][0]), 0)


@pytest.mark.parametrize("tw", [True, False])
def test_edge_rows(cuda, tw, monkeypatch):
    n, depots, k = 1000, 8, 40      # a route of every stop runs over time
    req = _requester(cuda, n, depots, k, tw)
    pop = _population(req, 64, seed=3)
    cols = req.build_frames(pop)["planning_stops"]
    v, c = cols["vehicle_id"].clone(), cols["customer_id"].clone()
    v[0:8][v[0:8] == 3] = 4                      # vehicle 3 empty
    v[8:12] = 0                                  # every stop on vehicle 0
    v[12:16] = k - 1                             # every stop on K - 1
    v[16:24] = torch.where(v[16:24] % 2 == 0, 0, k - 1)  # only 0, K - 1
    c[24:32] = depots + (c[24:32] % 5)           # five customers repeated
    c[32:36] = depots                            # one customer everywhere
    v[36:40] = 0
    c[36:40] = torch.arange(depots, depots + n, device=cuda)  # no repeats
    pop = _set_columns(req, pop, v, c)
    got, rows = _compare(req, pop)
    assert (got[3][0:8, 3] == 0).all()
    assert (got[3][8:12, 1:] == 0).all() and (got[3][12:16, :-1] == 0).all()
    assert (got[2][32:36] == n - 1).all() and (got[2][36:40] == 0).all()
    if tw:
        late, overtime = _walk(_utils(req), c[36].tolist())
        assert late > 0 and overtime > 0
        assert int(got[1][36]) == late + overtime
    else:
        assert (got[1] == 0).all()
    _scores_agree(req, (n, depots, k, tw), pop, rows, monkeypatch)


def test_the_cell_shape_in_scratch(cuda, monkeypatch):
    """The cell's rows, with the shared-memory limit lowered so they take
    the global scratch, and the scratch cut to 5 slabs for 96 rows so each
    block loops over rows."""
    shape = (1000, 8, 40, True)
    req = _requester(cuda, *shape)
    pop = _population(req, 96)
    monkeypatch.setattr(plain_kernel, "SMEM_MAX",
                        plain_kernel.shared_bytes(999, 40, 1008))
    monkeypatch.setattr(plain_kernel, "SCRATCH_MAX",
                        5 * 4 * plain_kernel.row_ints(1000, 40, 1008))
    assert plain_kernel.plan(96, 1000, 40, 1008, 132)[1:] == (
        5, 5 * plain_kernel.row_ints(1000, 40, 1008))
    _, rows = _compare(req, pop)
    _scores_agree(req, shape, pop, rows, monkeypatch)


@pytest.mark.parametrize("n, depots, k", [(15000, 8, 40), (2000, 8, 8000)])
def test_wide_rows(cuda, n, depots, k, monkeypatch):
    """Rows too wide for a block's shared memory: the kernel's outputs and
    the score rows equal the torch body's on the card."""
    req = _requester(cuda, n, depots, k, True)
    utils = _utils(req)
    assert not plain_kernel.fits(n, k, utils["n_locations"])
    pop = _population(req, 8)
    cols = req.build_frames(pop)["planning_stops"]
    v, c = cols["vehicle_id"].contiguous(), cols["customer_id"].contiguous()
    got = plain_kernel.route_analysis(v, c, utils)
    for name, g, w in zip(("distance", "penalty", "dups", "loads"), got,
                          _torch_ints(v, c, utils)):
        assert torch.equal(g.long(), w.long()), name
    rows = req.request_score_plain(pop)
    with monkeypatch.context() as m:
        m.setattr(plain_kernel, "eligible", lambda v, utils: False)
        assert torch.equal(rows, req.request_score_plain(pop))


def test_walk_past_the_i32_range(cuda):
    """Windows and services near the i32 limit, every stop on vehicle 0:
    the kernel walks in i64 and gives the sequential walk's penalty."""
    n, depots, k = 1000, 8, 40
    req = _requester(cuda, n, depots, k, True)
    utils = _utils(req)
    gen = torch.Generator().manual_seed(8)
    packed = utils["cust_packed"].cpu().clone()
    l = packed.shape[0]
    packed[:, 1] = torch.randint(2 ** 30, 2 ** 31 - 1, (l,), generator=gen)
    packed[:, 2] = torch.randint(2 ** 30, 2 ** 31 - 1, (l,), generator=gen)
    packed[:, 3] = torch.randint(0, 2 ** 28, (l,), generator=gen)
    utils["cust_packed"] = packed.to(cuda).contiguous()
    pop = _population(req, 4)
    cols = req.build_frames(pop)["planning_stops"]
    v = torch.zeros_like(cols["vehicle_id"]).contiguous()
    c = cols["customer_id"].contiguous()
    _, late, _, _ = plain_kernel.route_analysis(v, c, utils)
    for row in range(4):
        want_late, want_over = _walk(utils, c[row].tolist())
        assert want_late + want_over > 2 ** 40
        assert int(late[row]) == want_late + want_over


def _chunk():
    req = _requester("cuda", 200, 4, 10, True, seed=7)
    agent = TabuSearch(512, 0.2, True, None, None, 5, StepsLimit(6))
    runner = IslandRunner(agent.build_kernel(req, None), 4, 6)
    gens = island_generators(13, 4, req.device)
    state = runner.init(gens)
    alive = torch.ones(4, dtype=torch.bool, device=req.device)
    state = runner.run_chunk(state, gens, alive, {}, 6)
    return state["islands"]["population"], state["islands"]["scores"]


def test_tabu_chunk_bit_equal_to_the_torch_body(cuda, monkeypatch):
    before = plain_kernel.route_analysis.launches
    pop, scores = _chunk()
    assert plain_kernel.route_analysis.launches >= before + 6
    monkeypatch.setattr(plain_kernel, "eligible", lambda v, utils: False)
    before = plain_kernel.route_analysis.launches
    pop_t, scores_t = _chunk()
    assert plain_kernel.route_analysis.launches == before
    assert torch.equal(pop, pop_t) and torch.equal(scores, scores_t)


def test_traced_plain_solve_opens_the_kernel_span(cuda, tmp_path):
    db = DomainBuilder.from_generator(
        lambda: generate_instance(60, 2, 6, seed=3, time_windowed=True,
                                  device="cuda"))
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        Solver.solve(db, CotwinBuilder(False, True),
                     TabuSearch(256, 0.2, True, None, None, 5,
                                StepsLimit(8)), 4, seed=9,
                     logging_level=SolverLoggingLevels.Silent)
    out = tmp_path / "trace.json"
    prof.export_chrome_trace(str(out))
    with open(out) as f:
        events = json.load(f)["traceEvents"]
    spans = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation":
            spans.setdefault(e["name"], []).append(
                (float(e["ts"]), float(e["ts"]) + float(e["dur"])))
    kernel = spans.get("gj.score.kernel", [])
    assert len(kernel) == len(spans["gj.score.plain"]) > 0
    for s, e in kernel:
        assert any(ss <= s and e <= ee for ss, ee in spans["gj.score.plain"])


def test_the_wrapper_refuses_bad_inputs(cuda):
    req = _requester(cuda, 60, 2, 6, True)
    utils = _utils(req)
    cols = req.build_frames(_population(req, 8))["planning_stops"]
    v, c = cols["vehicle_id"], cols["customer_id"]
    wide = torch.zeros((8, 120), dtype=torch.int32, device=cuda)
    for bad_v, bad_c, what in (
            (v.cpu(), c.cpu(), "device"),
            (v.long(), c, "int32"),
            (wide[:, ::2], c, "contiguous"),
            (v, c.float(), "int32")):
        with pytest.raises(ValueError, match=what):
            plain_kernel.route_analysis(bad_v, bad_c, utils)
    bad = dict(utils, cust_packed=utils["cust_packed"].long())
    with pytest.raises(ValueError, match="cust_packed"):
        plain_kernel.route_analysis(v, c, bad)
