"""The CUDA delta kernel vs its plain torch version, on the card, on the
cases of `tests/test_torch_vrp_delta_kernel.py`: change+swap with and
without time windows, one-variable changes, swaps only, and a ctx advanced
by accepted winners; and on both of the kernel's routes ("shared" with
many rows an island, "direct" with few or with routes too long for the
shared slab), including routes that fill route_cap (Rp = 128 and 384);
and the C entry point's refusal of too little shared memory.

Needs an NVIDIA GPU with the CUDA toolkit; skips elsewhere. This file
imports only the port, so it also runs where jax is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_vrp_delta_kernel_cuda.py
"""

import pytest
import torch

from greyjack_tpu_torch.models.vrp import (CotwinBuilder, generate_instance,
                                           delta_kernel)
from greyjack_tpu_torch.ops import moves
from greyjack_tpu_torch.score_calculation.score_requesters import ScoreRequester
from greyjack_tpu_torch.solver.solver import island_generators

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _inputs(device, tw, probas, kd=2, n_updates=0, islands=2, p=256, seed=3,
            n=40, k=6, full_route=False):
    domain = generate_instance(n, 2 if k > 4 else 1, k, seed=seed,
                               time_windowed=tw, device=device)
    req = ScoreRequester(CotwinBuilder(True, True).build_cotwin(domain,
                                                                False))
    vm = req.variables_manager
    cfg = moves.MoverConfig(vm, 0.2, None, probas)
    gens = island_generators(seed, islands, device)
    base = torch.stack([vm.sample_variables(g, 1)[0] for g in gens])
    if full_route:
        # every stop of island 0 on vehicle 0: a route of route_cap stops
        ids = req.planning_schema["planning_stops"]["var_ids_np"]
        base[0, torch.as_tensor(ids["vehicle_id"]).long()] = 0
    ctx = req.build_base_ctx(base)
    tabu = cfg.init_tabu_state(islands)
    for _ in range(n_updates):
        d, _ = moves.move_population_delta(gens, base, 1, vm, cfg, tabu)
        w = {k: v[:, 0] for k, v in d.items()}
        base = moves.apply_delta(base, w)
        ctx = req.update_ctx(ctx, w)
    deltas, _ = moves.move_population_delta(gens, base, p, vm, cfg, tabu)
    # kd=1: the first entry of each move alone is a one-variable change
    deltas = {k: v[..., :kd].contiguous() for k, v in deltas.items()}
    return req, ctx, deltas


_CHANGE_SWAP = [0.5, 0.5, 0, 0, 0, 0]


@pytest.mark.parametrize("tw,probas,kd,n_updates", [
    (True, _CHANGE_SWAP, 2, 0),
    (False, _CHANGE_SWAP, 2, 0),
    (True, _CHANGE_SWAP, 1, 0),
    (False, _CHANGE_SWAP, 1, 0),
    (True, [0, 1.0, 0, 0, 0, 0], 2, 0),
    (True, _CHANGE_SWAP, 2, 3),
])
def test_kernel_matches_reference(cuda, tw, probas, kd, n_updates):
    req, ctx, deltas = _inputs(cuda, tw, probas, kd, n_updates)
    utils = req._delta_utils()
    inputs, aux = delta_kernel._pre(ctx, deltas, utils)
    before = delta_kernel._call_kernel.launches
    got = delta_kernel._call_kernel(inputs, utils, aux["kd"],
                                    aux["n_islands"])
    torch.cuda.synchronize()
    assert delta_kernel._call_kernel.launches == before + 1
    want = delta_kernel._kernel_reference(
        *inputs, kd=aux["kd"], tw=tw,
        rows_per_island=inputs[1].shape[0] // aux["n_islands"])
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    # and the whole scorer agrees with the same scorer on CPU tensors
    ints = delta_kernel.score_delta_batch_ints(ctx, deltas, utils)
    cpu = {k: v.cpu() if isinstance(v, torch.Tensor) else v
           for k, v in utils.items()}
    cpu["delta_schema"] = {k: v.cpu()
                           for k, v in utils["delta_schema"].items()}
    ints_cpu = delta_kernel.score_delta_batch_ints(
        {k: v.cpu() for k, v in ctx.items()},
        {k: v.cpu() for k, v in deltas.items()}, cpu)
    assert torch.equal(ints.cpu(), ints_cpu)


@pytest.mark.parametrize("p,route", [(256, "shared"), (1, "direct")])
@pytest.mark.parametrize("tw", [True, False])
@pytest.mark.parametrize("kd", [2, 1])
@pytest.mark.parametrize("full_route", [False, True])
def test_kernel_routes_match_reference(cuda, p, route, tw, kd, full_route):
    # n=40 over 6 vehicles (2 x 256 neighbours: 768 rows an island >= K,
    # the shared route; 2 x 1: 3 rows an island, the direct route), or
    # n=128 over 4 vehicles with island 0's every stop on vehicle 0, a
    # route that fills route_cap = Rp = 128
    n, k = (128, 4) if full_route else (40, 6)
    _check_route(cuda, p, route, tw, kd, n, k, full_route, rp=128)


@pytest.mark.parametrize("p", [256, 1])
@pytest.mark.parametrize("tw", [True, False])
@pytest.mark.parametrize("kd", [2, 1])
def test_kernel_long_routes_match_reference(cuda, p, tw, kd):
    # n=300 over 2 vehicles: route_cap 300, Rp = 384, too long for the
    # shared slab, so both neighbour counts take the direct route; island
    # 0's every stop on vehicle 0 fills route_cap, so a warp reads chunks
    # beyond the two it loads ahead, up to slot 300
    _check_route(cuda, p, "direct", tw, kd, 300, 2, True, rp=384)


def _check_route(device, p, route, tw, kd, n, k, full_route, rp):
    req, ctx, deltas = _inputs(device, tw, _CHANGE_SWAP, kd, p=p, n=n, k=k,
                               full_route=full_route)
    utils = req._delta_utils()
    inputs, aux = delta_kernel._pre(ctx, deltas, utils)
    rows = inputs[1].shape[0]
    plan = delta_kernel._kernel_plan(rows // aux["n_islands"],
                                     utils["k_vehicles"],
                                     inputs[0].shape[-1] // 6, tw)
    assert plan[0] == route
    assert inputs[0].shape[-1] // 6 == rp
    if full_route:
        assert int(ctx["len"][0].max()) == utils["route_cap"] == n
    got = delta_kernel._call_kernel(inputs, utils, aux["kd"],
                                    aux["n_islands"])
    torch.cuda.synchronize()
    want = delta_kernel._kernel_reference(
        *inputs, kd=aux["kd"], tw=tw,
        rows_per_island=rows // aux["n_islands"])
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("p", [256, 1])
def test_short_shared_memory_refused(cuda, p):
    # the C entry point recomputes the layout `_kernel_plan` sized and
    # refuses a launch given fewer bytes of shared memory
    req, ctx, deltas = _inputs(cuda, True, _CHANGE_SWAP, p=p)
    utils = req._delta_utils()
    inputs, aux = delta_kernel._pre(ctx, deltas, utils)
    outs = [torch.empty((inputs[1].shape[0], 8), dtype=torch.int32,
                        device=cuda) for _ in range(4)]
    args = list(delta_kernel._kernel_args(inputs, outs, utils, aux["kd"],
                                          aux["n_islands"]))
    stream = torch.cuda.current_stream().cuda_stream
    fn = delta_kernel._library().gj_vrp_delta
    assert fn(*args, stream) == 0
    args[-2] -= 1                          # smem_bytes, one byte short
    assert fn(*args, stream) != 0
    torch.cuda.synchronize()


def test_wrong_dtype_raises(cuda):
    req, ctx, deltas = _inputs(cuda, True, _CHANGE_SWAP)
    utils = req._delta_utils()
    inputs, aux = delta_kernel._pre(ctx, deltas, utils)
    bad = (inputs[0].to(torch.int64),) + inputs[1:]
    with pytest.raises(ValueError):
        delta_kernel._call_kernel(bad, utils, aux["kd"], aux["n_islands"])
