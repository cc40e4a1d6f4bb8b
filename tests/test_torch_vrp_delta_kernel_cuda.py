"""The CUDA delta kernel vs its plain torch version, on the card, on the
cases of `tests/test_torch_vrp_delta_kernel.py`: change+swap with and
without time windows, one-variable changes, swaps only, and a ctx advanced
by accepted winners.

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


def _inputs(device, tw, probas, kd=2, n_updates=0, islands=2, p=256, seed=3):
    domain = generate_instance(40, 2, 6, seed=seed, time_windowed=tw,
                               device=device)
    req = ScoreRequester(CotwinBuilder(True, True).build_cotwin(domain,
                                                                False))
    vm = req.variables_manager
    cfg = moves.MoverConfig(vm, 0.2, None, probas)
    gens = island_generators(seed, islands, device)
    base = torch.stack([vm.sample_variables(g, 1)[0] for g in gens])
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


def test_wrong_dtype_raises(cuda):
    req, ctx, deltas = _inputs(cuda, True, _CHANGE_SWAP)
    utils = req._delta_utils()
    inputs, aux = delta_kernel._pre(ctx, deltas, utils)
    bad = (inputs[0].to(torch.int64),) + inputs[1:]
    with pytest.raises(ValueError):
        delta_kernel._call_kernel(bad, utils, aux["kd"], aux["n_islands"])
