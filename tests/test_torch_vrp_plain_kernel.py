"""The host side of the VRP plain score's route analysis kernel
(`greyjack_tpu_torch/ops/plain_kernel.py`), on the CPU: importing it
builds and loads nothing; `eligible`, the rule `build_common` applies,
admits the card's integer-milli rows of any width and refuses the exact
f64 walk and a `dm_at` accessor; the launch plan keeps a row in shared
memory where it fits and gives wider rows a bounded global scratch; the
plan's constants are the .cu's; the wrapper refuses inputs off the card,
of another dtype or not contiguous before it loads the library; and on the CPU every VRP plain score (fast,
exact, partitioned accessor; with and without time windows) runs the
torch body. The kernel itself is compared with the torch body on the card
(`tests/test_torch_vrp_plain_kernel_cuda.py`)."""

import os
import re
import subprocess
import sys
import types

import pytest
import torch

from greyjack_tpu_torch.models.vrp import CotwinBuilder, generate_instance
from greyjack_tpu_torch.models.vrp import cotwin_builder
from greyjack_tpu_torch.ops import plain_kernel
from greyjack_tpu_torch.score_calculation.score_requesters import (
    ScoreRequester)
from greyjack_tpu_torch.solver.solver import island_generators

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _requester(tw, exact=False, n=40, depots=2, k=5):
    domain = generate_instance(n, depots, k, seed=4, time_windowed=tw,
                               device="cpu")
    return ScoreRequester(CotwinBuilder(False, False, exact).build_cotwin(
        domain, False))


def _utils(req):
    return dict(req.cotwin.score_calculator.utility_objects)


def _on_card(n, p=8):
    """A stand-in for a CUDA column [p, n] (all `eligible` reads)."""
    return types.SimpleNamespace(is_cuda=True, shape=(p, n))


def test_importing_builds_and_loads_nothing():
    code = ("import greyjack_tpu_torch.models.vrp, "
            "greyjack_tpu_torch.ops.plain_kernel as k, "
            "greyjack_tpu_torch.cuda_build as b; "
            "assert k._LIB == {} and 'vrp_plain' not in b.BUILD_INFO; "
            "print('ok')")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


@pytest.mark.parametrize("tw", [True, False])
def test_the_rule(tw):
    utils = _utils(_requester(tw))
    n = utils["n_stops"]
    assert plain_kernel.eligible(_on_card(n), utils)
    assert not plain_kernel.eligible(torch.zeros((8, n), dtype=torch.int32),
                                     utils)
    assert not plain_kernel.eligible(
        _on_card(n), dict(utils, exact_fp_scores=True))
    assert not plain_kernel.eligible(
        _on_card(n), dict(utils, dm_at=lambda idx: idx))
    # rows wider than a block's shared memory run the kernel too
    wide = 60 * 1024
    assert not plain_kernel.fits(wide, 5, 42)
    assert plain_kernel.eligible(_on_card(wide), utils)


def test_fits():
    assert plain_kernel.fits(1000, 40, 1008)
    assert plain_kernel.shared_bytes(1000, 40, 1008) < 48 * 1024
    assert plain_kernel.fits(10000, 40, 10008)
    assert not plain_kernel.fits(15000, 40, 15008)
    assert not plain_kernel.fits(100, 8000, 108)      # many vehicles
    assert not plain_kernel.fits(100, 4, 2 ** 23)     # a wide bitmap


@pytest.mark.parametrize("rows, n, k, l, blocks", [
    (16384, 1000, 40, 1008, 16384),     # the plain cell: a block a row
    (3, 15000, 40, 15008, 3),           # wide: no more blocks than rows
    (16384, 15000, 40, 15008, 1056),    # wide: 8 blocks an SM of 132
    (16384, 2 ** 22, 40, 2 ** 22, 3),   # wide: slabs within SCRATCH_MAX
])
def test_the_plan(rows, n, k, l, blocks):
    smem, got, scratch = plain_kernel.plan(rows, n, k, l, 132)
    assert got == blocks
    per = plain_kernel.row_ints(n, k, l)
    if plain_kernel.fits(n, k, l):
        assert smem == plain_kernel.RED_BYTES + 4 * per and scratch == 0
    else:
        assert smem == plain_kernel.RED_BYTES
        assert scratch == blocks * per
        assert 4 * scratch <= plain_kernel.SCRATCH_MAX


def test_the_plan_matches_the_kernel_source():
    with open(plain_kernel._SOURCE) as f:
        src = f.read()
    threads = int(re.search(r"constexpr int kThreads = (\d+);", src)[1])
    assert threads == 32 * plain_kernel.WARPS
    smem = re.search(r"constexpr long long kSmemMax = (\d+) \* (\d+);", src)
    assert int(smem[1]) * int(smem[2]) == plain_kernel.SMEM_MAX
    enum = re.search(r"enum Dim \{([^}]*)\}", src)[1]
    names = [s.strip() for s in enum.split(",")]
    assert names[-1] == "kNDims"
    want = ["k" + "".join(w.capitalize() for w in d.split("_"))
            for d in plain_kernel.DIMS]
    assert names[:-1] == want
    assert re.search(r"constexpr long long kRedBytes = "
                     r"8 \* 2 \* kWarps \+ 4 \* kWarps;", src)
    assert plain_kernel.RED_BYTES == 8 * 2 * 8 + 4 * 8
    assert re.search(r"return 4 \* n \+ kWarps \* k \+ 3 \* k "
                     r"\+ \(l \+ 31\) / 32;", src)
    assert plain_kernel.row_ints(1000, 40, 1008) == (
        4 * 1000 + 8 * 40 + 3 * 40 + 32)
    # the entry point's pointers: two columns, five tables, four outputs,
    # the scratch, the dims and the stream
    entry = re.search(r'extern "C" int gj_vrp_plain\(([^)]*)\)', src)[1]
    assert entry.count("*") == 14


@pytest.mark.parametrize("what", ["device", "int32", "contiguous"])
def test_the_wrapper_refuses_before_loading(what, monkeypatch):
    def no_build(*args):
        raise AssertionError("the library was loaded")

    monkeypatch.setattr(plain_kernel, "_library", no_build)
    req = _requester(True)
    utils = _utils(req)
    pop = req.variables_manager.sample_variables(
        island_generators(3, 1, "cpu")[0], 6)
    cols = req.build_frames(pop)["planning_stops"]
    v, c = cols["vehicle_id"], cols["customer_id"]
    bad = {"device": (v, c),
           "int32": (v.long(), c),
           "contiguous": (torch.zeros((6, 2 * v.shape[1]),
                                      dtype=torch.int32)[:, ::2], c)}
    with pytest.raises(ValueError, match=what):
        plain_kernel.route_analysis(*bad[what], utils)


@pytest.mark.parametrize("tw", [True, False])
@pytest.mark.parametrize("form", ["fast", "exact", "dm_at"])
def test_cpu_scores_run_the_torch_body(tw, form, monkeypatch):
    def no_kernel(*args):
        raise AssertionError("the kernel was called")

    monkeypatch.setattr(plain_kernel, "route_analysis", no_kernel)
    req = _requester(tw, exact=form == "exact")
    pop = req.variables_manager.sample_variables(
        island_generators(5, 1, "cpu")[0], 12)
    got = req.request_score_plain(pop)
    assert got.shape == (12, 3)
    if form == "dm_at":
        utils = _utils(req)
        flat = utils["dm_flat_milli"]
        seen = []

        def dm_at(idx):
            seen.append(idx.shape)
            return flat[idx.long()]

        assert torch.equal(req.request_score_plain(pop, {"dm_at": dm_at}),
                           got)
        assert seen
    common = cotwin_builder.build_common(
        req.build_frames(pop), None, _utils(req))
    assert common["route_distance"].dtype == torch.float64
    assert common["vehicle_loads"].dtype == torch.int32
