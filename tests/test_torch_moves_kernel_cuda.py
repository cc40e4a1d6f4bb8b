"""The plain step's move sampler kernel (`csrc/move_sample.cu`) against
the torch body on the card, fed the same uniforms: `fix_all(do_move(...))`
and the tabu info, bit for bit. Cases: the VRP n=1000 cell's shapes (8 x
2048, all six moves, tabu 0.2); each move type alone; tabu off; a non-zero
mutation-rate multiplier; f32 and f64 rows; groups smaller than a
scramble window and groups of one; a real [I, P, V] population as well as
the island's base expanded with stride 0. Then whole TabuSearch,
LateAcceptance and SimulatedAnnealing plain VRP solves, bit-equal with the
kernel and with the torch body (forced by a monkeypatch), and a traced
plain solve whose every step opens `gj.moves.kernel` inside
`gj.moves.sample`.

Needs an NVIDIA GPU with the CUDA toolkit; skips elsewhere. This file
imports only the port, so it also runs where jax is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_moves_kernel_cuda.py
"""

import json

import pytest
import torch

from greyjack_tpu_torch.agents import (LateAcceptance, SimulatedAnnealing,
                                       TabuSearch)
from greyjack_tpu_torch.agents.termination_strategies import StepsLimit
from greyjack_tpu_torch.models.vrp import (CotwinBuilder, DomainBuilder,
                                           generate_instance)
from greyjack_tpu_torch.ops import move_kernel, moves
from greyjack_tpu_torch.score_calculation.score_requesters import (
    ScoreRequester, VariablesManager)
from greyjack_tpu_torch.solver import Solver, SolverLoggingLevels
from greyjack_tpu_torch.solver.solver import island_generators
from greyjack_tpu_torch.variables import GJFloat, GJInteger

pytestmark = pytest.mark.cuda

ONE_HOT = [[1.0 if i == k else 0.0 for i in range(6)] for k in range(6)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _vrp_vm(device, n, depots, k, dtype=None):
    domain = generate_instance(n, depots, k, seed=5, time_windowed=True,
                               device=device)
    vm = ScoreRequester(CotwinBuilder(False, True).build_cotwin(
        domain, False)).variables_manager
    if dtype is not None:
        vm = VariablesManager(vm.variables, device, float_dtype=dtype)
    return vm


def _small_vm(device, group_size, dtype):
    """Four groups of `group_size` integer and float variables, and three
    frozen ones (in no group), so that the fix clamps, rints and pins."""
    variables = []
    for i in range(4 * group_size + 3):
        frozen = i >= 4 * group_size
        if i % 2:
            var = GJFloat(0.5 if frozen else None, -2.5, 7.25, frozen,
                          [f"g{i % 4}"])
        else:
            var = GJInteger(2 if frozen else None, 0, 9, frozen,
                            [f"g{i % 4}"])
        var.set_name(f"x{i}")
        variables.append(var)
    return VariablesManager(variables, device, float_dtype=dtype)


def _tabu(vm, cfg, gens, rounds=6):
    """Tabu rings filled by a few rounds of pushed moves."""
    tabu = cfg.init_tabu_state(len(gens))
    base = torch.stack([vm.sample_variables(g, 1)[0] for g in gens])
    pop = base[:, None].expand(len(gens), 64, base.shape[-1])
    for r in range(rounds):
        _, info = moves.do_move(pop, moves.draw_move_noise(
            gens, 64, vm, cfg, base.dtype), vm, cfg, cfg.tabu_masks(tabu))
        tabu = moves.update_tabu_from_info(
            tabu, info, torch.full((len(gens),), r, device=base.device))
    return tabu


def _compare(vm, cfg, n_isl, p, real, seed=11, moved_some=False):
    dev = vm.device
    gens = island_generators(seed, n_isl, dev)
    tabu = _tabu(vm, cfg, gens)
    if real:
        # a population off the grid and out of bounds, so the fix works
        pop = torch.stack([vm.sample_variables(g, p) for g in gens])
        pop = pop + 3.0 * torch.rand(pop.shape, generator=gens[0],
                                     dtype=pop.dtype, device=dev) - 1.5
    else:
        base = torch.stack([vm.sample_variables(g, 1)[0] for g in gens])
        pop = base[:, None].expand(n_isl, p, base.shape[-1])
    fields = moves.move_noise_fields(vm, cfg)
    u = moves.draw_uniforms(gens, p, fields, dev)
    masks = cfg.tabu_masks(tabu)
    before = move_kernel.move_and_fix.launches
    got, got_info = move_kernel.move_and_fix(u, moves.field_columns(fields),
                                             pop, vm, cfg, masks)
    torch.cuda.synchronize()
    assert move_kernel.move_and_fix.launches == before + 1
    moved, info = moves.do_move(pop, moves.noise_leaves(u, fields, cfg,
                                                        pop.dtype),
                                vm, cfg, masks)
    want = vm.fix_all(moved)
    assert got.dtype == want.dtype and got.shape == want.shape
    bad = torch.nonzero(got.view(torch.int8) != want.view(torch.int8))
    assert bad.numel() == 0, f"rows differ at {bad[:8].tolist()}"
    for key in ("group", "positions", "count"):
        assert torch.equal(got_info[key], info[key].to(torch.int32)), key
    if moved_some:
        assert not torch.equal(got, vm.fix_all(pop.contiguous()))


def test_vrp_cell_shapes(cuda):
    vm = _vrp_vm(cuda, 1000, 8, 40)
    assert vm.max_group_size == 2000
    cfg = moves.MoverConfig(vm, 0.2, None, None)
    _compare(vm, cfg, 8, 2048, real=False, moved_some=True)


@pytest.mark.parametrize("move", range(6))
def test_each_move_alone(cuda, move):
    vm = _vrp_vm(cuda, 120, 2, 8)
    _compare(vm, moves.MoverConfig(vm, 0.2, None, ONE_HOT[move]), 2, 512,
             real=False, moved_some=True)


@pytest.mark.parametrize("real", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("tabu,mult", [(0.2, None), (0.0, None), (0.2, 2.0),
                                       (0.0, 0.5)])
def test_configurations(cuda, real, dtype, tabu, mult):
    vm = _vrp_vm(cuda, 120, 2, 8, dtype)
    _compare(vm, moves.MoverConfig(vm, tabu, mult, None), 3, 384, real)


@pytest.mark.parametrize("group_size", [1, 2, 4, 5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("probas", [None, ONE_HOT[3], [0.0, 0.0, 0.0, 0.0,
                                                       0.5, 0.5]])
def test_small_groups(cuda, group_size, dtype, probas):
    vm = _small_vm(cuda, group_size, dtype)
    assert vm.max_group_size == group_size
    for mult in (None, 1.5):
        cfg = moves.MoverConfig(vm, 0.3, mult, probas)
        _compare(vm, cfg, 2, 256, real=True)
        _compare(vm, cfg, 2, 256, real=False)


def _db():
    return DomainBuilder.from_generator(
        lambda: generate_instance(60, 2, 6, seed=3, time_windowed=True,
                                  device="cuda"))


def _agent(name):
    return {"TS": lambda: TabuSearch(256, 0.2, True, None, None, 5,
                                     StepsLimit(14)),
            "LA": lambda: LateAcceptance(10, 0.2, 1.0, None, 5,
                                         StepsLimit(14)),
            "SA": lambda: SimulatedAnnealing([1000.0, 1000.0, 1.0], 0.9999,
                                             0.2, None, None, 5,
                                             StepsLimit(14))}[name]()


def _solve(name):
    return Solver.solve(_db(), CotwinBuilder(False, True), _agent(name), 4,
                        seed=9, logging_level=SolverLoggingLevels.Silent)


def _torch_body(u, columns, population, vm, cfg, masks):
    fields = moves.move_noise_fields(vm, cfg)
    moved, info = moves.do_move(population, moves.noise_leaves(
        u, fields, cfg, population.dtype), vm, cfg, masks)
    return vm.fix_all(moved), info


@pytest.mark.parametrize("name", ["TS", "LA", "SA"])
def test_plain_solves_bit_equal_to_the_torch_body(cuda, name, monkeypatch):
    before = move_kernel.move_and_fix.launches
    with_kernel = _solve(name)
    assert move_kernel.move_and_fix.launches > before
    monkeypatch.setattr(move_kernel, "move_and_fix", _torch_body)
    assert _solve(name) == with_kernel


def test_traced_plain_solve_opens_the_kernel_span(cuda, tmp_path):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _solve("TS")
    out = tmp_path / "trace.json"
    prof.export_chrome_trace(str(out))
    with open(out) as f:
        events = json.load(f)["traceEvents"]
    spans = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation":
            spans.setdefault(e["name"], []).append(
                (float(e["ts"]), float(e["ts"]) + float(e["dur"])))
    kernel = spans.get("gj.moves.kernel", [])
    assert len(kernel) == len(spans["gj.runner.step"]) > 0
    for s, e in kernel:
        assert any(ss <= s and e <= ee for ss, ee in spans["gj.moves.sample"])
        assert any(ss <= s and e <= ee for ss, ee in spans["gj.runner.step"])
