"""The host side of the plain step's move sampler kernel
(`greyjack_tpu_torch/ops/move_kernel.py`), on the CPU: the column table
the kernel is given matches `draw_move_noise`'s field list, leaf by leaf,
for each configuration of the tests; layouts the kernel does not read are
refused; and on the CPU `move_population` runs the torch body and fixes
its rows, as the kernel does on the card, and never calls the kernel. The kernel itself is compared with the torch body on the
card (`tests/test_torch_moves_kernel_cuda.py`)."""

import pytest
import torch

from greyjack_tpu_torch.models.vrp import CotwinBuilder, generate_instance
from greyjack_tpu_torch.ops import move_kernel, moves
from greyjack_tpu_torch.score_calculation.score_requesters import (
    ScoreRequester, VariablesManager)
from greyjack_tpu_torch.solver.solver import island_generators
from greyjack_tpu_torch.variables import GJFloat, GJInteger


@pytest.fixture(scope="module")
def vrp_vm():
    domain = generate_instance(30, 2, 5, seed=3, time_windowed=True,
                               device="cpu")
    return ScoreRequester(CotwinBuilder(False, True).build_cotwin(
        domain, False)).variables_manager


def _small_vm(group_size):
    variables = [GJInteger(None, 0, 9, False, [f"g{i % 3}"]) if i % 2 else
                 GJFloat(None, -1.0, 4.0, False, [f"g{i % 3}"])
                 for i in range(3 * group_size)]
    return VariablesManager(variables, "cpu", float_dtype=torch.float64)


CONFIGS = {
    "tabu": (0.2, None, None),
    "no-tabu": (0.0, None, None),
    "rates": (0.2, 2.0, None),
    "change-swap": (0.2, None, [0.5, 0.5, 0.0, 0.0, 0.0, 0.0]),
    "scramble": (0.0, 1.0, [0.0, 0.0, 0.0, 1.0, 0.0, 0.0]),
}


def _vm(name, vrp_vm):
    return {"vrp": lambda: vrp_vm, "groups-of-1": lambda: _small_vm(1),
            "groups-of-4": lambda: _small_vm(4)}[name]()


@pytest.mark.parametrize("model", ["vrp", "groups-of-1", "groups-of-4"])
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_noise_dims_match_the_draw_layout(model, config, vrp_vm):
    vm = _vm(model, vrp_vm)
    cfg = moves.MoverConfig(vm, *CONFIGS[config])
    fields = moves.move_noise_fields(vm, cfg)
    dims = move_kernel.noise_dims(moves.field_columns(fields),
                                  vm.variables_count, vm.max_group_size)
    # the columns by an independent walk of the field list
    col, first = 0, {}
    for name, w, _, _ in fields:
        first[name] = col
        col += w or 1
    assert dims["width"] == col
    for name, (_, _, dim) in move_kernel._LEAVES.items():
        assert dims[dim] == first.get(name, -1), name
    assert (dims["off_count"] == -1) == cfg.rates_zero
    assert (dims["g_lo"], dims["g_hi"]) == (0, max(1, cfg.n_groups))
    assert (dims["kscr_lo"], dims["kscr_hi"]) == (3, 7)

    # the leaves of the draw are the kernel's columns turned by their kind
    gens = island_generators(4, 2, "cpu")
    u = moves.draw_uniforms(gens, 16, fields, "cpu")
    assert u.shape == (2, 16, dims["width"])
    leaves = moves.noise_leaves(u, fields, cfg, vm.float_dtype)
    lmax = vm.max_group_size

    def cols(dim, n=None):
        return u[..., dims[dim]] if n is None else \
            u[..., dims[dim]:dims[dim] + n]

    assert torch.equal(leaves["u_move"], cols("off_move"))
    assert torch.equal(leaves["g"], moves.uniform_ints(cols("off_g"), 0,
                                                       dims["g_hi"]))
    assert torch.equal(leaves["gumbel"], moves.gumbel_f32(
        moves.uniform_f32(cols("off_gumbel", lmax))))
    assert torch.equal(leaves["k_scr"], moves.uniform_ints(cols("off_kscr"),
                                                           3, 7))
    assert torch.equal(leaves["u_start"], moves.uniform_f32(cols("off_start")))
    assert torch.equal(leaves["perm_gumbel"], moves.gumbel_f32(
        moves.uniform_f32(cols("off_perm", 6))))
    res = cols("off_res", 8)
    assert torch.equal(leaves["u_res"], res if vm.float_dtype == torch.float64
                       else moves.uniform_f32(res))
    if not cfg.rates_zero:
        assert torch.equal(leaves["c_raw"], moves.binomial_counts(
            moves.uniform_f32(cols("off_count", vm.variables_count)),
            cfg.group_rates[leaves["g"].long()]))
    # and the split draw is the one draw_move_noise makes
    again = moves.draw_move_noise(island_generators(4, 2, "cpu"), 16, vm, cfg,
                                  vm.float_dtype)
    assert all(torch.equal(again[k], leaves[k]) for k in leaves)


def test_noise_dims_refuse_other_layouts(vrp_vm):
    cfg = moves.MoverConfig(vrp_vm, 0.2, None, None)
    v, lmax = vrp_vm.variables_count, vrp_vm.max_group_size
    delta = moves.field_columns(moves.delta_noise_fields(vrp_vm, cfg))
    with pytest.raises(ValueError, match="unexpected noise leaf"):
        move_kernel.noise_dims(delta, v, lmax)
    fields = moves.move_noise_fields(vrp_vm, cfg)
    narrow = [f if f[0] != "gumbel" else ("gumbel", lmax - 1, "gumbel", None)
              for f in fields]
    with pytest.raises(ValueError, match="'gumbel' is gumbel"):
        move_kernel.noise_dims(moves.field_columns(narrow), v, lmax)
    with pytest.raises(ValueError, match="no noise leaf"):
        move_kernel.noise_dims(moves.field_columns(fields[:-1]), v, lmax)


ONE_HOT = [[1.0 if i == k else 0.0 for i in range(6)] for k in range(6)]


@pytest.mark.parametrize("probas", [None] + ONE_HOT)
def test_cpu_move_population_runs_the_torch_body(probas, vrp_vm,
                                                 monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the kernel was called on the CPU")

    monkeypatch.setattr(move_kernel, "move_and_fix", refuse)
    cfg = moves.MoverConfig(vrp_vm, 0.2, 1.0, probas)
    tabu = cfg.init_tabu_state(2)
    base = torch.stack([vrp_vm.sample_variables(g, 1)[0]
                        for g in island_generators(6, 2, "cpu")])
    pop = base[:, None].expand(2, 64, base.shape[-1])
    got, info = moves.move_population(island_generators(8, 2, "cpu"), pop,
                                      vrp_vm, cfg, tabu)
    noise = moves.draw_move_noise(island_generators(8, 2, "cpu"), 64, vrp_vm,
                                  cfg, pop.dtype)
    moved, want_info = moves.do_move(pop, noise, vrp_vm, cfg,
                                     cfg.tabu_masks(tabu))
    assert torch.equal(got, vrp_vm.fix_all(moved))
    assert all(torch.equal(info[k], want_info[k]) for k in info)
    assert not torch.equal(got, vrp_vm.fix_all(pop.contiguous()))
    if probas == ONE_HOT[0]:  # the change move's values are rinted
        assert not torch.equal(moved, got)


def test_move_and_fix_refuses_a_cpu_population(vrp_vm):
    cfg = moves.MoverConfig(vrp_vm, 0.2, None, None)
    fields = moves.move_noise_fields(vrp_vm, cfg)
    u = moves.draw_uniforms(island_generators(1, 1, "cpu"), 4, fields, "cpu")
    pop = torch.zeros((1, 4, vrp_vm.variables_count))
    with pytest.raises(ValueError, match="unsupported device"):
        move_kernel.move_and_fix(u, moves.field_columns(fields), pop, vrp_vm,
                                 cfg, None)
