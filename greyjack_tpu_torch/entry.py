"""Driver entry points of the port (counterpart of `__graft_entry__.py`).

`entry()` returns the flagship's forward step, the VRP population plain
score (the hot path of the whole framework), with an example population
on the card.

`dryrun_multichip(n)` runs three legs on an n-rank world: the sweep
TabuSearch chunk under the islands mesh, the int-delta TabuSearch chunk
(the fused delta kernel, `csrc/vrp_delta.cu`, on a card) under the same
mesh, and the partitioned-facts plain score over an (islands, facts) grid,
checked bit-identical to the replicated score. Called on every rank of an
initialised n-rank world it runs there; otherwise it starts the world
itself, one process a rank, with a `file://` store in a temporary
directory.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import time

import torch
import torch.distributed as dist


def _flagship(n_customers=32, n_depots=2, k_vehicles=6, seed=0,
              device="cuda"):
    from greyjack_tpu_torch.models.vrp import CotwinBuilder, generate_instance
    from greyjack_tpu_torch.score_calculation.score_requesters import (
        ScoreRequester)

    domain = generate_instance(n_customers, n_depots, k_vehicles, seed=seed,
                               time_windowed=True, device=device)
    cotwin = CotwinBuilder(True, False).build_cotwin(domain, False)
    return domain, ScoreRequester(cotwin)


def entry(device="cuda"):
    """(step, args): the plain score of 16 sampled rows of the flagship,
    on `device` (the card unless the caller names another)."""
    _, req = _flagship(device=device)
    gen = torch.Generator(device=req.device)
    gen.manual_seed(0)
    pop = req.variables_manager.sample_variables(gen, 16)
    return req.request_score_plain, (pop,)


def _chunk(req, agent, mesh, n_islands, seed):
    """One chunk of 2 steps on `n_islands` islands (this rank's part
    under a mesh); returns (runner, state)."""
    from greyjack_tpu_torch.parallel import IslandRunner
    from greyjack_tpu_torch.solver.solver import island_generators

    runner = IslandRunner(agent.build_kernel(req, None), n_islands, 2,
                          mesh=mesh)
    gens = island_generators(seed, n_islands, req.device)[
        runner.local_islands]
    state = runner.init(gens)
    alive = torch.ones(n_islands, dtype=torch.bool, device=req.device)
    return runner, runner.run_chunk(state, gens, alive, {}, 2)


def _dryrun_legs(mesh):
    from greyjack_tpu_torch.agents import TabuSearch
    from greyjack_tpu_torch.agents.termination_strategies import StepsLimit
    from greyjack_tpu_torch.models.vrp import delta_kernel
    from greyjack_tpu_torch.ops import partitioned
    from greyjack_tpu_torch.parallel.mesh import make_island_mesh

    n = mesh.size
    dev = mesh.device
    lead = mesh.is_lead

    # --- leg 1: the sweep TabuSearch chunk under the mesh --------------------
    _, req = _flagship(12, 1, 3, device=dev)
    agent = TabuSearch(8, 0.2, True, None, [0.5, 0.5, 0.0, 0.0, 0.0, 0.0],
                       2, StepsLimit(4), sweep=True, sweep_targets=4,
                       sweep_window=4)
    runner, state = _chunk(req, agent, mesh, 2 * n, seed=0)
    if runner.kernel.path != "sweep":
        raise RuntimeError(f"leg 1 ran path {runner.kernel.path}")
    _, alone = _chunk(req, agent, None, 2 * n, seed=0)
    if not torch.equal(state["global_score"], alone["global_score"]):
        raise RuntimeError("leg 1: the mesh's global best differs from one "
                           "device's")
    if lead:
        print("dryrun_multichip ok:", state["global_score"].tolist(),
              flush=True)

    # --- leg 2: the fused delta kernel under the mesh ------------------------
    _, req2 = _flagship(96, 2, 8, device=dev)
    agent2 = TabuSearch(64, 0.2, True, None, [0.5, 0.5, 0, 0, 0, 0], 2,
                        StepsLimit(2))
    probe = {"positions": torch.zeros((64, 2), dtype=torch.int32)}
    if not delta_kernel.eligible(req2._delta_utils(), probe):
        raise RuntimeError("the delta kernel is ineligible at the dryrun "
                           "shapes")
    before = delta_kernel._call_kernel.launches
    runner2, state2 = _chunk(req2, agent2, mesh, n, seed=2)
    launched = delta_kernel._call_kernel.launches - before
    if runner2.kernel.path != "int-delta":
        raise RuntimeError(f"leg 2 ran path {runner2.kernel.path}")
    if dev.type == "cuda" and launched <= 0:
        raise RuntimeError("leg 2 never launched the delta kernel")
    if lead:
        print(f"dryrun_multichip delta-kernel ok: "
              f"{state2['global_score'].tolist()} ({launched} launches on "
              f"rank 0)", flush=True)

    # --- leg 3: (islands, facts) grid, the matrix row-sharded ---------------
    n_facts = 2 if n % 2 == 0 else 1
    grid = make_island_mesh(group=mesh.group, facts=n_facts)
    fn = req.partitioned_plain_score_fn(grid.facts_group)
    dm_milli = req.cotwin.score_calculator.utility_objects[
        "distance_matrix_milli"]
    dm_flat, r = partitioned.shard_rows_flat(dm_milli, n_facts)
    span = r * dm_milli.shape[1]
    block = dm_flat[grid.facts_index * span:(grid.facts_index + 1) * span]
    gen = torch.Generator(device=dev)
    gen.manual_seed(5 + grid.index)
    pop = req.variables_manager.sample_variables(gen, 4)
    out = fn(block, pop)
    if not torch.equal(out, req.request_score_plain(pop)):
        raise RuntimeError("leg 3: the partitioned score differs from the "
                           "replicated one")
    if lead:
        print("dryrun_multichip partitioned-facts ok:", tuple(out.shape),
              "bit-identical", flush=True)


def _dryrun_worker(rank, world, init_url, device):
    from greyjack_tpu_torch.parallel.mesh import init_distributed

    mesh = init_distributed(init_url, world, rank, device=device)
    try:
        _dryrun_legs(mesh)
    finally:
        dist.destroy_process_group()


DRYRUN_TIMEOUT_S = 600


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """The three legs on an `n_devices`-rank world (NCCL on the cards, or
    gloo with device="cpu"); raises if a leg fails, and ends a world it
    started that outlives DRYRUN_TIMEOUT_S seconds."""
    from greyjack_tpu_torch.parallel.mesh import make_island_mesh

    if dist.is_initialized():
        if dist.get_world_size() != n_devices:
            raise ValueError(f"the initialised world has "
                             f"{dist.get_world_size()} ranks, not "
                             f"{n_devices}")
        _dryrun_legs(make_island_mesh())
        return
    import torch.multiprocessing as mp

    tmp = tempfile.mkdtemp(prefix="gj_dryrun_")
    try:
        url = "file://" + os.path.join(tmp, "store")
        ctx = mp.start_processes(_dryrun_worker,
                                 args=(n_devices, url, device),
                                 nprocs=n_devices, join=False,
                                 start_method="spawn")
        deadline = time.monotonic() + DRYRUN_TIMEOUT_S
        # join returns False while a rank still runs; it raises (and ends
        # the others) when a rank fails
        while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
            if time.monotonic() > deadline:
                for proc in ctx.processes:
                    proc.kill()
                raise TimeoutError(f"dryrun_multichip({n_devices}) outlived "
                                   f"{DRYRUN_TIMEOUT_S} s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    import sys

    # python -m greyjack_tpu_torch.entry [N [DEVICE]]
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 1,
                     device=sys.argv[2] if len(sys.argv) > 2 else "cuda")
