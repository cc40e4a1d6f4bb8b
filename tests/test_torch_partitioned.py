"""Row-partitioned facts on the CPU: twin of `tests/test_partitioned.py`.

A 2-rank gloo world (`tests/_torch_mesh_worker.py`, suite
"partitioned") forms the (islands, facts) grid twice: F = 1 (two island
rows, each its own facts group) and F = 2 (one island row whose two ranks
each hold half the matrix's rows). The owner-computes gathers must equal
the dense lookup, and the partitioned plain scores of the VRP (30
customers) and the TSP (25 locations) must equal the port's dense score
and the JAX package's dense score of the same populations. Tolerance:
none, every comparison is exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import _torch_mesh_worker as w
from greyjack_tpu.models.tsp import (CotwinBuilder as JTspCotwin,
                                     generate_uniform_instance as j_tsp)
from greyjack_tpu.models.vrp import (CotwinBuilder as JVrpCotwin,
                                     generate_instance as j_vrp)
from greyjack_tpu.score_calculation.score_requesters import (
    ScoreRequester as JScoreRequester)
from greyjack_tpu_torch.ops import partitioned

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return w.launch("partitioned", 2, tmp_path_factory.mktemp("facts"), 300)


@pytest.mark.parametrize("facts", [1, 2])
def test_sharded_dm_gather_matches_dense(ranks, facts):
    dm, u, v = w.gather_case()
    rows = -(-dm.shape[0] // facts)
    for rank, res in enumerate(ranks):
        got = res[f"gather-F{facts}"]
        row = got["row"]
        assert row == (rank if facts == 1 else 0)
        # each rank holds only its row block
        assert got["shard_rows"] == rows
        want = dm[u[row], v[row]]
        np.testing.assert_array_equal(got["dense"], want)
        np.testing.assert_array_equal(got["flat"], want)
        assert got["dense"].dtype == np.int32


def test_shard_rows_pads_with_zero_rows():
    dm = torch.arange(12, dtype=torch.int32).reshape(3, 4)
    padded, r = partitioned.shard_rows(dm, 2)
    assert r == 2 and padded.shape == (4, 4)
    assert torch.equal(padded[:3], dm) and not padded[3].any()
    flat, r = partitioned.shard_rows_flat(dm, 3)
    assert r == 1 and torch.equal(flat, dm.reshape(-1))
    flat, r = partitioned.shard_rows_flat(dm, 2)
    assert r == 2 and torch.equal(flat, padded.reshape(-1))


_JAX_REQ = {
    "vrp": lambda: JScoreRequester(JVrpCotwin(True, True).build_cotwin(
        j_vrp(30, 2, 6, seed=4, time_windowed=True), False)),
    "tsp": lambda: JScoreRequester(JTspCotwin(True, True).build_cotwin(
        j_tsp(25, seed=6), False)),
}
_PORT_REQ = {"vrp": w.vrp_requester, "tsp": w.tsp_requester}


@pytest.mark.parametrize("facts", [1, 2])
@pytest.mark.parametrize("model", ["vrp", "tsp"])
def test_partitioned_plain_scores_bit_identical(ranks, model, facts):
    treq = _PORT_REQ[model]()
    jreq = _JAX_REQ[model]()
    for rank, res in enumerate(ranks):
        got = res[f"{model}-F{facts}"]
        pop = got["population"]
        dense = treq.request_score_plain(torch.from_numpy(pop)).numpy()
        jdense = np.asarray(jreq.request_score_plain(jnp.asarray(pop)))
        assert got["scores"].dtype == np.float64
        np.testing.assert_array_equal(got["scores"], dense,
                                      err_msg=f"rank {rank}")
        np.testing.assert_array_equal(got["scores"], jdense,
                                      err_msg=f"rank {rank}")
    if facts == 2:
        # one island row: both ranks scored the same population
        np.testing.assert_array_equal(ranks[0][f"{model}-F2"]["population"],
                                      ranks[1][f"{model}-F2"]["population"])


def test_partitioned_refuses_exact_fp_scores():
    from greyjack_tpu_torch.models.vrp import CotwinBuilder, generate_instance
    from greyjack_tpu_torch.score_calculation.score_requesters import (
        ScoreRequester)

    domain = generate_instance(12, 1, 3, seed=2, device="cpu")
    req = ScoreRequester(CotwinBuilder(True, True, exact_fp_scores=True)
                         .build_cotwin(domain, False))
    with pytest.raises(ValueError, match="integer-milli score path"):
        req.partitioned_plain_score_fn()
