"""The port's multi-device islands on the CPU: twin of
`tests/test_islands_multidevice.py` and `tests/test_multihost.py`.

Gloo worlds of 2 and 1 ranks (`tests/_torch_mesh_worker.py`, one process
a rank, a `file://` store in `tmp_path`, a timeout that kills the world)
run the sharded island runner and `Solver.solve(mesh=...)`; this process
runs the same cases without a mesh. Every island draws from its own
generator, so the sharded runs must equal the single-device runs bit for
bit: the whole state, every generator's state and the global best after
every chunk, the solutions and the metrics records. Tolerance: none,
every comparison is exact.
"""

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import _torch_mesh_worker as w
from greyjack_tpu_torch.parallel import IslandRunner
from greyjack_tpu_torch.parallel.mesh import IslandMesh
from greyjack_tpu_torch.solver.checkpoint import load_checkpoint

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """{world size: [each rank's results]}, the 2- and 1-rank worlds run
    side by side, and the directory holding the 2-rank world's files."""
    out = tmp_path_factory.mktemp("mesh")
    with ThreadPoolExecutor(2) as pool:
        futures = {n: pool.submit(w.launch, "mesh", n, out, 420)
                   for n in (2, 1)}
        results = {n: f.result() for n, f in futures.items()}
    return results, out


@pytest.fixture(scope="module")
def single():
    """Each solve case without a mesh, in this process."""
    return {label: w.run_solve(label) for label in w.SOLVES}


def assert_tree_equal(want, got, path=""):
    if isinstance(want, dict):
        assert list(want) == list(got), path
        for k in want:
            assert_tree_equal(want[k], got[k], f"{path}/{k}")
    elif isinstance(want, list):
        assert len(want) == len(got), path
        for i, (a, b) in enumerate(zip(want, got)):
            assert_tree_equal(a, b, f"{path}[{i}]")
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert got == want, path


@pytest.mark.parametrize("agent", ["TS", "LA", "GA"])
def test_sharded_runner_equals_single_device(worlds, agent):
    """TabuSearch and LateAcceptance (the LocalSearch arm, LA's ring) and
    GA (the Population arm) on N-Queens 10, 4 islands over 2 ranks, 3
    chunks: each chunk's whole state (every island leaf, the global best)
    and every island's generator state equal the single-device runner's;
    both ranks gather the same."""
    results, _ = worlds
    want = w.run_runner(agent)
    r0, r1 = (r[f"runner-{agent}"] for r in results[2])
    assert_tree_equal(want, r0, f"runner-{agent}")
    assert_tree_equal(r0, r1, f"runner-{agent} rank 1")
    # the run moved: the global best left the stub row
    assert want[-1]["state"]["global_score"][0] < 1e30


@pytest.mark.parametrize("world", [2, 1])
@pytest.mark.parametrize("label", list(w.SOLVES))
def test_mesh_solve_equals_single_device(worlds, single, label, world):
    """`Solver.solve(mesh=...)`: every rank returns the single-device
    solution; the lead's metrics records (global bests, alive counts,
    paths, sweep counters) equal the single-device records, and the other
    ranks record nothing."""
    results, _ = worlds
    sol, recs = single[label]
    for rank, res in enumerate(results[world]):
        got_sol, got_recs = res[f"solve-{label}"]
        assert got_sol == sol, f"rank {rank}"
        assert got_recs == (recs if rank == 0 else []), f"rank {rank}"
    if label == "vrp-sweep":
        assert recs[-1]["sweep_scored"] > 0
    assert {r["kernel_path"] for r in recs} == {
        "vrp-int-delta": {"int-delta"}, "vrp-sweep": {"sweep"}}.get(
            label, {recs[0]["kernel_path"]})


def test_mesh_checkpoint_resumes_either_way(worlds, single):
    """A checkpoint written under a 2-rank mesh is the whole state: it
    holds all 4 islands' generators, and resumed without a mesh (here) or
    under the mesh (on the ranks) it gives the uninterrupted solve."""
    results, out = worlds
    sol, recs = single["vrp-int-delta"]
    full_sol, _ = results[2][0]["ckpt-full"]
    assert full_sol == sol
    snap = os.path.join(out, "mesh_snapshot.ckpt")
    held = load_checkpoint(snap)
    assert held["chunk_id"] == w.CKPT_CHUNK
    assert len(held["generators"]) == w.SOLVE_ISLANDS
    assert held["state"]["islands"]["top_score"].shape[0] == w.SOLVE_ISLANDS
    got, got_recs = w.run_solve("vrp-int-delta", resume_from=snap)
    assert got == sol
    assert got_recs == recs[w.CKPT_CHUNK:]
    for rank, res in enumerate(results[2]):
        assert res["ckpt-resumed-mesh"][0] == sol, f"rank {rank}"


def test_seedless_mesh_solve_agrees_across_ranks(worlds):
    """Without a seed every rank draws from the first rank's: both return
    the same solution."""
    results, _ = worlds
    r0, r1 = (r["solve-seedless"][0] for r in results[2])
    assert r0 == r1


def test_uneven_islands_rejected():
    """6 islands do not divide over a 4-rank islands axis: refused with the
    JAX package's message before any collective."""
    mesh = IslandMesh(None, 4, 0, torch.device("cpu"))
    with pytest.raises(ValueError, match="must divide evenly over the "
                       "4-device islands mesh axis"):
        IslandRunner(w.nq_kernel("TS"), n_islands=6, migration_frequency=2,
                     mesh=mesh)


def test_workers_import_no_jax(worlds):
    results, _ = worlds
    for n, ranks in results.items():
        assert not any(r["jax_imported"] for r in ranks), n
