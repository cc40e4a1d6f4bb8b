"""Score rows on the card equal the CPU's, bit for bit: the VRP plain score
(the fast integer-milli walk and the exact f64 fold, with and without time
windows), the per-neighbour f64 `score_delta` rows and `true_div` itself.
CUDA turns a division by a Python number into a product with its
reciprocal (x / 1000.0 against x * 0.001, which can differ in the last
bit); the port's score assembly divides by a tensor to keep the true
quotient the CPU and the JAX package compute.

Needs an NVIDIA GPU; skips elsewhere. Imports only the port:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_card_scores_cuda.py
"""

import pytest
import torch

from greyjack_tpu_torch.models.vrp import CotwinBuilder, generate_instance
from greyjack_tpu_torch.ops import moves
from greyjack_tpu_torch.score_calculation.score_requesters import ScoreRequester
from greyjack_tpu_torch.solver.solver import island_generators
from greyjack_tpu_torch.utils.math_utils import true_div

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def test_true_div_is_the_true_quotient(cuda):
    x = torch.arange(0, 2_000_000, 7, dtype=torch.float64)
    want = x / 1000.0                          # the CPU's true division
    got = true_div(x.to(cuda), 1000.0).cpu()
    assert torch.equal(got, want)


def _requesters(tw, exact, incremental=True):
    return {dev: ScoreRequester(CotwinBuilder(
        incremental, True, exact_fp_scores=exact).build_cotwin(
            generate_instance(60, 2, 8, seed=5, time_windowed=tw,
                              device=dev), False))
            for dev in ("cuda", "cpu")}


@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("tw", [True, False])
def test_plain_scores_card_equal_cpu(cuda, tw, exact):
    reqs = _requesters(tw, exact)
    vm = reqs["cpu"].variables_manager
    pop = torch.cat([vm.sample_variables(g, 64)
                     for g in island_generators(2, 4, "cpu")])
    pop[:8] = vm.initial_values
    want = reqs["cpu"].request_score_plain(pop)
    got = reqs["cuda"].request_score_plain(pop.to(cuda)).cpu()
    assert torch.equal(got, want)


@pytest.mark.parametrize("tw", [True, False])
def test_delta_rows_card_equal_cpu(cuda, tw):
    reqs = _requesters(tw, False)
    vm = reqs["cpu"].variables_manager
    cfg = moves.MoverConfig(vm, 0.2, None, None)
    gens = island_generators(3, 2, "cpu")
    base = torch.stack([vm.sample_variables(g, 1)[0] for g in gens])
    deltas, _ = moves.move_population_delta(gens, base, 64, vm, cfg,
                                            cfg.init_tabu_state(2))
    out = {}
    for dev, req in reqs.items():
        ctx = req.build_base_ctx(base.to(dev))
        d = {k: v.to(dev) for k, v in deltas.items()}
        out[dev] = (req.request_score_delta(ctx, d).cpu(),
                    req.ctx_score_row(ctx).cpu())
    assert torch.equal(out["cuda"][0], out["cpu"][0])
    assert torch.equal(out["cuda"][1], out["cpu"][1])
